"""Flash-decode: one query token against a (shard of a) KV cache."""
