"""Memcached-analogue storage: the hopscotch and cuckoo tables and the
sharded KV store with its one-sided / two-sided / RedN-offload get paths.

The package's public surface, re-exported so callers write ``from
repro_torch.kvstore import ShardedKVService, DeleteResult``:

* result types: :class:`GetResult`, :class:`SetResult`,
  :class:`DeleteResult`, :class:`SweepReport`, plus :class:`Admission`
  (``sharded_get``'s isolation parameter) and :class:`WriterFaultConflict`
  (the typed ``n_writers``/``faults`` exclusivity error);
* status vocabulary: :data:`STATUS_NAMES` / :func:`status_name`;
* the host-side oracle table :class:`HopscotchTable` and the serving
  facade :class:`ShardedKVService` (lazy: it lives in
  ``repro_torch.rdma.failure``, which itself imports this package).
"""
from . import cuckoo, fsck, hopscotch, store  # noqa: F401
from .hopscotch import STATUS_NAMES, HopscotchTable, status_name  # noqa: F401
from .store import (  # noqa: F401
    Admission,
    DeleteResult,
    GetResult,
    SetResult,
    SweepReport,
    WriterFaultConflict,
)

__all__ = [
    "cuckoo", "hopscotch", "store", "fsck",
    "Admission", "DeleteResult", "GetResult", "SetResult", "SweepReport",
    "WriterFaultConflict", "STATUS_NAMES", "status_name", "HopscotchTable",
    "ShardedKVService",
]


def __getattr__(name):
    # deferred: repro_torch.rdma.failure imports this package, so an eager
    # import here would trip the cycle when failure loads first
    if name == "ShardedKVService":
        from ..rdma.failure import ShardedKVService
        return ShardedKVService
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
