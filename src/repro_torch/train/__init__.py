"""Step builders (prefill and serve; training comes later)."""
