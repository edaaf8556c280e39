"""Serving: the batched decode engine with token-bucket isolation and a
disposable host driver."""
from .engine import ServeEngine  # noqa: F401
