"""Device selection for the port's entry points.

Every entry point that allocates state takes a ``device`` argument.  It
defaults to CUDA and raises when no card is present: the port never falls
back to the CPU on its own, because a CPU run silently standing in for the
card would hide the device.  Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device to run on: ``device`` if given, else CUDA (or raise)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    return dev
