"""Single-WQ chain executors: the managed-WQ and straight-line kernels."""
