"""Data-parallel and edge-partitioned training over ``torch.distributed``
(counterpart of ``gsn_tpu/parallel/``).  The trainers are imported on
first use: the model's modules import ``parallel.collectives``, and the
trainers import the model."""

from .collectives import all_gather, all_reduce
from .mesh import Mesh, init_rank, launch, make_mesh

_LAZY = {
    "DataParallelTrainer": "dp", "make_global_batch": "dp",
    "EdgePartitionedTrainer": "ep", "make_ep_batch": "ep",
    "ParallelTrainer": "trainer",
}

__all__ = ["Mesh", "all_gather", "all_reduce", "init_rank", "launch",
           "make_mesh", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
