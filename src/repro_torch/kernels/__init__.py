"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

Each kernel directory holds a plain version (``ref.py``) and a wrapper
(``ops.py``) that takes the plain version for CPU tensors and launches the
kernel (``csrc/<name>.cu``, built by :mod:`._build`) for CUDA tensors.

* ``chain_vm`` — batches of single-WQ chains, one client context per block
  (managed WQ and straight-line forms).
* ``hopscotch`` — the batched hopscotch get, one thread per query.
* ``flash_attention`` — blocked online-softmax attention, forward, one
  block per (query tile, head, batch row), and its backward (a dQ kernel
  per query tile, a dK/dV kernel per key tile and KV head).
* ``decode_attention`` — the flash-decode partial of one query token,
  one block per (KV head, batch row).
* ``rwkv6`` — the WKV6 recurrence, one block per (batch row, head) with
  the state in registers.
* ``rglru`` — the RG-LRU recurrence, one thread per (batch row, channel).
"""
