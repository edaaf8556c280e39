"""The 'RNIC' layer: one-sided/two-sided transport between virtual shards."""
