"""The RWKV6 (Finch) WKV recurrence with data-dependent decay."""
