"""Data-parallel and edge-partitioned training over ``torch.distributed``
(counterpart of ``gsn_tpu/parallel/``).  The trainers, and the
``distributed`` and ``edge_partition`` modules, are imported on first
use: the model's modules import ``parallel.collectives``, and those
import the model."""

from .collectives import all_gather, all_reduce
from .mesh import Mesh, init_rank, launch, make_mesh

_LAZY = {
    "DataParallelTrainer": "dp", "make_global_batch": "dp",
    "EdgePartitionedTrainer": "ep", "make_ep_batch": "ep",
    "ParallelTrainer": "trainer",
}
_LAZY_MODULES = ("distributed", "edge_partition")

__all__ = ["Mesh", "all_gather", "all_reduce", "init_rank", "launch",
           "make_mesh", *_LAZY, *_LAZY_MODULES]


def __getattr__(name):
    import importlib
    if name in _LAZY_MODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY:
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
