from .batching import (epoch_caps, infer_y_spec, iterate_batches,
                       tight_epoch_caps)
from .container import GraphBatch, batch_graphs, pad_cap
from .patterns import cycle_graph

__all__ = [
    "GraphBatch", "batch_graphs", "pad_cap", "cycle_graph",
    "epoch_caps", "infer_y_spec", "iterate_batches", "tight_epoch_caps",
]
