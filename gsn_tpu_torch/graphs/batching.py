"""Epoch batching with static-shape buckets (a copy of
``gsn_tpu/graphs/batching.py``, its batches also kept as an
``EpochBatches`` that builds each when first asked for).

Shuffled mini-batches are padded to bucket capacities rounded up to
coarse multiples, so a dataset sees a handful of distinct batch shapes
instead of one per batch.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .container import GraphBatch, batch_graphs, pad_cap

NODE_BUCKET = 128
EDGE_BUCKET = 256

# geometric bucket boundaries: each ~1.33x the previous, so tight
# per-epoch capacities land on a handful of distinct shapes even
# when shuffling reshuffles the worst batch every epoch
_BUCKETS = [128]
while _BUCKETS[-1] < 64 * 1024 * 1024:
    nxt = _BUCKETS[-1] * 4 // 3
    _BUCKETS.append(((nxt + 63) // 64) * 64)


def round_to_bucket(n: int) -> int:
    for b in _BUCKETS:
        if b >= n:
            return b
    return pad_cap(n, 1024)


def epoch_caps(graphs: List[Dict], batch_size: int) -> Tuple[int, int, int]:
    """Worst-case per-batch capacities over any batch_size-subset: the sum
    of the largest batch_size graphs, bucket-rounded.  Shuffle-safe."""
    n_sizes = sorted((g["x"].shape[0] for g in graphs), reverse=True)
    e_sizes = sorted((g["edge_index"].shape[1] for g in graphs), reverse=True)
    node_cap = round_to_bucket(sum(n_sizes[:batch_size]))
    edge_cap = round_to_bucket(sum(e_sizes[:batch_size]))
    graph_cap = pad_cap(batch_size, 8)
    return node_cap, edge_cap, graph_cap


def tight_epoch_caps(order: np.ndarray, graphs: List[Dict],
                     batch_size: int) -> Tuple[int, int, int]:
    """Capacities for a *known* epoch order, geometric-bucket-rounded
    (tighter than worst-case; bounded shape variety across epochs)."""
    n_max = e_max = 0
    for i in range(0, len(order), batch_size):
        idx = order[i:i + batch_size]
        n_max = max(n_max, sum(graphs[j]["x"].shape[0] for j in idx))
        e_max = max(e_max, sum(graphs[j]["edge_index"].shape[1] for j in idx))
    return (round_to_bucket(n_max), round_to_bucket(e_max),
            pad_cap(batch_size, 8))


class EpochBatches(Sequence):
    """An epoch's batches in an order drawn when it is made (``rng``'s
    shuffle; 'tight' caps, where ``caps`` is None, from that order),
    each built by ``batch_graphs`` when first indexed and kept, so an
    epoch can build a batch while the steps before it run."""

    def __init__(self, graphs: List[Dict], batch_size: int,
                 shuffle: bool = False,
                 rng: Optional[np.random.RandomState] = None,
                 caps: Optional[Tuple[int, int, int]] = None,
                 y_shape: tuple = (), y_dtype=np.int64,
                 flow: str = "source_to_target"):
        order = np.arange(len(graphs))
        if shuffle:
            (rng or np.random).shuffle(order)
        if caps is None:
            caps = tight_epoch_caps(order, graphs, batch_size)
        self.graphs, self.caps = graphs, caps
        self.chunks = [order[i:i + batch_size]
                       for i in range(0, len(order), batch_size)]
        self._spec = dict(y_shape=y_shape, y_dtype=y_dtype, flow=flow)
        self._built: Dict[int, GraphBatch] = {}

    def __len__(self) -> int:
        return len(self.chunks)

    def __getitem__(self, k: int) -> GraphBatch:
        k = range(len(self.chunks))[k]
        if k not in self._built:
            self._built[k] = self.build(k)
        return self._built[k]

    def build(self, k: int) -> GraphBatch:
        """Batch ``k``, built anew."""
        return batch_graphs([self.graphs[j] for j in self.chunks[k]],
                            *self.caps, **self._spec)


def iterate_batches(
    graphs: List[Dict],
    batch_size: int,
    shuffle: bool = False,
    rng: Optional[np.random.RandomState] = None,
    caps: Optional[Tuple[int, int, int]] = None,
    y_shape: tuple = (),
    y_dtype=np.int64,
    drop_last: bool = False,
    flow: str = "source_to_target",
) -> Iterator[GraphBatch]:
    """``EpochBatches``' batches in turn, none kept; the order is drawn
    at the first ``next``."""
    batches = EpochBatches(graphs, batch_size, shuffle, rng, caps, y_shape,
                           y_dtype, flow)
    for k, idx in enumerate(batches.chunks):
        if drop_last and len(idx) < batch_size:
            break
        yield batches.build(k)


def infer_y_spec(graphs: List[Dict]) -> Tuple[tuple, type]:
    y0 = np.asarray(graphs[0]["y"])
    return tuple(y0.reshape(-1).shape) if y0.ndim else (), y0.dtype
