"""Assigned architecture config (see archs.py for the exact fields; a copy
of the JAX package's module)."""
from .archs import GEMMA3_1B as CONFIG  # noqa: F401
from .archs import smoke_of


def smoke_config():
    return smoke_of(CONFIG)
