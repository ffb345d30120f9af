"""Edge-partitioned execution of the full GSN model (counterpart of
``gsn_tpu/parallel/ep.py``).

One batch is split over the ranks of the ``ep`` axis:

- node-level arrays are block-partitioned (rank d owns node slots
  [d·N/D, (d+1)·N/D) of the padded disjoint union);
- edges are receiver-partitioned, so each receiver's messages are summed
  on its own rank, in the batch's order; sender rows cross the ranks
  once per layer as the post-projection rows B (an all-gather), which
  K1/K2 read by global sender id (the reference's ``num_send_nodes``
  mode), and dB comes back through the all-gather's reduce-scatter;
- BN statistics are summed over the axis and the pools sum the blocks'
  partial per-graph sums, so the graph-level rows, the head and the loss
  are the same on every rank (replicated).

In place of the reference's per-shard slab metadata, each shard carries
the segment layout of ``graphs/container.py``: local receiver offsets,
and the sender offsets and permutation over the global sender space.
Every shard of a batch has one edge slot count, floored by a caller's
high-water mark (``e_cap``, as in the reference): a captured step
(``train/graphs.py``) is bound to its batch's shapes, so every rank must
hold the same shapes, and a mark carried across batches keeps an epoch
at one shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gsn_tpu_torch.graphs.container import (GraphBatch, _csr, pad_cap,
                                            pad_perm)
from .dp import MeshTrainer, rank_generator


def ep_edge_slots(data: GraphBatch, num_devices: int,
                  e_cap: Optional[int] = None) -> int:
    """The edge slot count of every shard of ``data`` split over
    ``num_devices`` ranks: ``pad_cap`` of the largest over the shards of
    its edge count and its share of the batch's edge slots (on one rank
    the shard's edge arrays are the batch's, padding included), at
    least ``e_cap`` (reference ``gsn_tpu/parallel/ep.py:105-112``)."""
    return _edge_slots(data, num_devices,
                       _block_edges(data, num_devices)[1], e_cap)


def _edge_slots(data: GraphBatch, num_devices: int, counts,
                e_cap: Optional[int]) -> int:
    """``ep_edge_slots`` from the blocks' edge counts ``counts``."""
    return max(pad_cap(max(int(counts.max()),
                           -(-data.num_edge_slots // num_devices))),
               e_cap or 0)


def _block_edges(data: GraphBatch, num_devices: int):
    """(each block's first edge, each block's edge count): the batch's
    real edges are stably receiver-sorted, so a block's edges are one
    run of them."""
    block = data.num_node_slots // num_devices
    recv_g = np.asarray(data.edge_index[data.select, :data.num_real_edges])
    bounds = np.searchsorted(recv_g, np.arange(num_devices + 1) * block)
    return bounds[:-1], np.diff(bounds)


def make_ep_batch(data: GraphBatch, num_devices: int, axis: str = "ep",
                  ids_on_edges: Optional[bool] = None,
                  rank: Optional[int] = None,
                  e_cap: Optional[int] = None):
    """Split a host (numpy) batch into ``num_devices`` edge-partitioned
    shards (``GraphBatch`` with ``ep_axis=axis``): the list of shards,
    or with ``rank`` only that rank's.

    Per shard: the node arrays of its block; its edges (those whose
    receiver lies in the block) in the batch's receiver-sorted order,
    with ``edge_index`` rows (local receiver, global sender), padded to
    ``ep_edge_slots(data, num_devices, e_cap)``, one count for every
    shard (the padding slots carry nothing: no segment reaches them);
    ``recv_ptr``/``in_degree``
    over the block; ``send_ptr`` [N+1] over the global senders and
    ``send_perm`` [slots] (its real edges', then the padding's own
    positions, as ``graphs/container.py`` pads it); ``graph_ptr``
    clipped to the block; the batch's graph-level
    arrays.  ``ids_on_edges`` says whether the identifiers are
    edge-level where their row count is the node cap and the edge cap
    alike.  Raises when the node cap is not a multiple of
    ``num_devices``."""
    N = data.num_node_slots
    D = num_devices
    if N % D:
        raise ValueError(f"node cap {N} not divisible by {D}")
    block = N // D
    E = data.num_real_edges
    recv_g = np.asarray(data.edge_index[data.select, :E])
    send_g = np.asarray(data.edge_index[1 - data.select, :E])
    starts, counts = _block_edges(data, D)
    slots = _edge_slots(data, D, counts, e_cap)

    if data.identifiers is not None:
        rows = data.identifiers.shape[0]
        if ids_on_edges is None:
            if rows == data.num_edge_slots and rows == N:
                raise ValueError(
                    "identifiers row count matches both node and edge "
                    "caps; pass ids_on_edges=True/False explicitly")
            ids_on_edges = rows == data.num_edge_slots and rows != N

    def shard(d: int) -> GraphBatch:
        lo, hi = d * block, (d + 1) * block
        # the block's edges, already in local receiver order
        e0, n_e = int(starts[d]), int(counts[d])
        e1 = e0 + n_e
        recv, send = recv_g[e0:e1] - lo, send_g[e0:e1]
        edge_index = np.zeros((2, slots), np.int32)
        edge_index[0, :n_e], edge_index[1, :n_e] = recv, send
        edge_mask = np.zeros(slots, bool)
        edge_mask[:n_e] = True

        def nodes(a):
            return None if a is None else a[lo:hi].copy()

        def edges(a):
            if a is None:
                return None
            out = np.zeros((slots,) + a.shape[1:], a.dtype)
            out[:n_e] = a[e0:e1]
            return out

        return dataclasses.replace(
            data, x=nodes(data.x), edge_index=edge_index,
            batch=nodes(data.batch), y=data.y.copy(),
            node_mask=nodes(data.node_mask), edge_mask=edge_mask,
            graph_mask=data.graph_mask.copy(),
            degrees=nodes(data.degrees),
            recv_ptr=_csr(recv, block),
            send_perm=pad_perm(np.argsort(send, kind="stable"), slots),
            send_ptr=_csr(send, N),
            graph_ptr=(np.clip(data.graph_ptr, lo, hi) - lo).astype(
                np.int32),
            in_degree=nodes(data.in_degree),
            identifiers=(edges(data.identifiers) if ids_on_edges
                         else nodes(data.identifiers)),
            edge_features=edges(data.edge_features),
            node_eig=nodes(data.node_eig), edge_eig=edges(data.edge_eig),
            ep_axis=axis, num_real_edges=n_e)

    if rank is not None:
        return shard(rank)
    return [shard(d) for d in range(D)]


class EdgePartitionedTrainer(MeshTrainer):
    """Train steps of the full model on edge-partitioned shards over the
    ``ep`` axis (reference ``gsn_tpu/parallel/ep.py::
    EdgePartitionedTrainer``).  Every rank computes the same replicated
    loss; ``backward_replicated`` divides it by the world size before
    the gradients are summed, as the reference's ``_global_loss`` does.
    Graph-level dropout draws from one stream all ranks share; node
    dropout from each rank's own (``nn.models.DropoutStreams``)."""

    def generators(self, seed: int):
        shared = torch.Generator(device=self.mesh.device)
        shared.manual_seed(seed)
        return shared, rank_generator(self.mesh.device, seed,
                                      self.mesh.rank + 1)

    def loss(self, y_hat, data: GraphBatch) -> torch.Tensor:
        """The replicated loss (the pools made ``y_hat`` global)."""
        return self.loss_fn(y_hat, data.y, data.graph_mask)

    @torch.no_grad()
    def forward(self, state, shard: GraphBatch) -> torch.Tensor:
        """The replicated [G, out] predictions in eval mode."""
        model = state.model.eval()
        return model(shard.to(self.mesh.device))

