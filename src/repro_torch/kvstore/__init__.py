"""Memcached-analogue storage: the hopscotch table and the sharded KV store
with its one-sided / two-sided / RedN-offload get paths."""
