"""The RedN reproduction on PyTorch and CUDA (Hopper).

A second package beside the JAX reference ``repro``: the chain VM, the
offload programs, the sharded hopscotch store and its transport, with the
TPU kernels rewritten by hand as CUDA kernels (``csrc/``) that keep a plain
PyTorch version beside them.  Entry points run on the card by default and
raise without one unless the caller passes ``device="cpu"``.
"""
