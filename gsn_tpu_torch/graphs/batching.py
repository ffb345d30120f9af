"""Epoch batching with static-shape buckets (a copy of
``gsn_tpu/graphs/batching.py``).

Shuffled mini-batches are padded to bucket capacities rounded up to
coarse multiples, so a dataset sees a handful of distinct batch shapes
instead of one per batch.
"""

from __future__ import annotations

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
    order = np.arange(len(graphs))
    if shuffle:
        (rng or np.random).shuffle(order)
    if caps is None:
        caps = tight_epoch_caps(order, graphs, batch_size)
    node_cap, edge_cap, graph_cap = caps
    for i in range(0, len(order), batch_size):
        idx = order[i:i + batch_size]
        if drop_last and len(idx) < batch_size:
            break
        yield batch_graphs([graphs[j] for j in idx], node_cap, edge_cap,
                           graph_cap, y_shape=y_shape, y_dtype=y_dtype,
                           flow=flow)


def infer_y_spec(graphs: List[Dict]) -> Tuple[tuple, type]:
    y0 = np.asarray(graphs[0]["y"])
    return tuple(y0.reshape(-1).shape) if y0.ndim else (), y0.dtype
