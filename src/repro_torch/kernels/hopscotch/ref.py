"""Oracle for the batched hopscotch probe (the kvstore's plain PyTorch
lookup, which the host-side table construction also tests)."""
from __future__ import annotations

from ...kvstore import hopscotch as _h


def lookup_reference(keys, values, queries, neighborhood: int):
    return _h.lookup(keys, values, queries, neighborhood)
