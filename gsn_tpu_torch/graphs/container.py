"""Batched padded graph container (counterpart of
``gsn_tpu/graphs/container.py``).

A batch of graphs is a single disjoint union padded to fixed
node/edge/graph capacities; boolean masks carry the real extents, and
every op downstream (aggregation, batch-norm, pooling, loss) is masked so
padding never contributes.

Conventions (the same as the reference package):
- messages aggregate onto ``edge_index[select]`` where ``select`` is 1
  under ``flow='source_to_target'`` and 0 under ``'target_to_source'``;
- padding edges point at node slot 0 and sit at the tail, masked out;
- padding nodes belong to graph slot 0 and sit at the tail, masked out.

In place of the TPU slab metadata, ``batch_graphs`` builds the **segment
layout** that the CUDA kernels walk directly:
- the real edges are stably sorted by receiver (the same order the
  reference's slab layout produces), padding edges after them;
- ``recv_ptr [N+1]``: CSR offsets of each receiver's edges;
- ``send_perm [E_real]`` / ``send_ptr [N+1]``: a stable sender-sorted
  permutation of the real edges and its CSR offsets, so sender-side sums
  are deterministic segment reductions with no float atomics;
- ``graph_ptr [G+1]``: node offsets of each graph (padding excluded);
- ``in_degree [N]``: float32 receiver in-degree.

An edge-partitioned shard (``parallel/ep.py::make_ep_batch``, the
counterpart of ``gsn_tpu/parallel/ep.py``) is a ``GraphBatch`` with
``ep_axis`` set: its node arrays are one block of the batch's node
slots, ``edge_index`` row 0 holds each of its edges' receiver local to
the block and row 1 the sender's global id (the partitioner has applied
the flow), ``recv_ptr``/``in_degree`` cover the block, ``send_ptr`` and
``send_perm`` the global sender space, and ``graph_ptr`` is clipped to
the block (a graph may lie in two blocks); graph-level arrays are the
whole batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class GraphBatch:
    """One padded disjoint-union batch of graphs.

    Built as numpy arrays on the host; ``to(device)`` returns the same
    batch with every array a torch tensor on ``device``."""

    x: Any                          # [N, Dx] node features (int or float)
    edge_index: Any                 # [2, E]  int32, receiver-sorted
    batch: Any                      # [N]     int32 graph id per node
    y: Any                          # [G, ...] labels
    node_mask: Any                  # [N]     bool
    edge_mask: Any                  # [E]     bool
    graph_mask: Any                 # [G]     bool
    degrees: Any                    # [N] or [N, Kd]
    recv_ptr: Any                   # [N+1]   int32
    send_perm: Any                  # [E_real] int32
    send_ptr: Any                   # [N+1]   int32
    graph_ptr: Any                  # [G+1]   int32
    in_degree: Any                  # [N]     float32
    identifiers: Any = None         # [N, K] or [E, K]
    edge_features: Any = None       # [E, De]
    # DGN vector fields: node- and edge-level eigenvectors or counts
    node_eig: Any = None            # [N, Dv] float32
    edge_eig: Any = None            # [E, Dv] float32, receiver-sorted
    flow: str = "source_to_target"  # which edge_index row is the receiver
    ep_axis: Optional[str] = None   # mesh axis of an edge-partitioned shard

    @property
    def num_node_slots(self) -> int:
        return self.x.shape[0]

    @property
    def num_edge_slots(self) -> int:
        return self.edge_index.shape[1]

    @property
    def num_graph_slots(self) -> int:
        return self.y.shape[0]

    @property
    def num_real_edges(self) -> int:
        return int(self.send_perm.shape[0])

    @property
    def select(self) -> int:
        """Row of ``edge_index`` holding the receiver (row 0 in an
        edge-partitioned shard, whatever the flow)."""
        if self.ep_axis is not None:
            return 0
        return 0 if self.flow == "target_to_source" else 1

    def to(self, device) -> "GraphBatch":
        import torch

        def conv(v):
            if isinstance(v, np.ndarray):
                return torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, torch.Tensor):
                return v.to(device)
            return v

        return dataclasses.replace(
            self, **{f.name: conv(getattr(self, f.name))
                     for f in dataclasses.fields(self)})


def mask_off(data: GraphBatch) -> GraphBatch:
    """An all-padding view of a host (numpy) batch: no real node, edge
    or graph, every mask False and every segment empty, so BN
    statistics, messages, pools, the loss and the metrics see nothing of
    it (the dummy shards of a parallel tail batch, reference
    ``gsn_tpu/parallel/trainer.py::_mask_off``)."""
    return dataclasses.replace(
        data,
        node_mask=np.zeros_like(data.node_mask),
        edge_mask=np.zeros_like(data.edge_mask),
        graph_mask=np.zeros_like(data.graph_mask),
        recv_ptr=np.zeros_like(data.recv_ptr),
        send_perm=data.send_perm[:0],
        send_ptr=np.zeros_like(data.send_ptr),
        graph_ptr=np.zeros_like(data.graph_ptr),
        in_degree=np.zeros_like(data.in_degree))


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple if multiple > 1 else x


def pad_cap(n: int, multiple: int = 64) -> int:
    """Bucket capacity: next multiple (bounds the variety of shapes)."""
    return max(_round_up(max(n, 1), multiple), multiple)


def _csr(keys: np.ndarray, num_segments: int) -> np.ndarray:
    """int32 CSR offsets [num_segments+1] of sorted segment ids."""
    ptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=num_segments)[:num_segments],
              out=ptr[1:])
    return ptr.astype(np.int32)


def batch_graphs(
    graphs: List[Dict[str, Any]],
    node_cap: Optional[int] = None,
    edge_cap: Optional[int] = None,
    graph_cap: Optional[int] = None,
    y_shape: tuple = (),
    y_dtype=np.int64,
    flow: str = "source_to_target",
) -> GraphBatch:
    """Disjoint-union a list of numpy graph dicts into one padded batch.

    Each graph dict has keys: ``x`` [n, Dx], ``edge_index`` [2, e],
    ``degrees`` [n] or [n, Kd], ``y``, and optionally ``identifiers``
    ([n, K] for vertex scope / [e, K] for edge scope) and
    ``edge_features`` [e, De], ``node_eig`` [n, Dv] and ``edge_eig``
    [e, Dv] (the DGN vector fields, float32).
    """
    n_tot = sum(g["x"].shape[0] for g in graphs)
    e_tot = sum(g["edge_index"].shape[1] for g in graphs)
    node_cap = node_cap or pad_cap(n_tot)
    edge_cap = edge_cap or pad_cap(e_tot)
    graph_cap = graph_cap or pad_cap(len(graphs), 8)
    if n_tot > node_cap or e_tot > edge_cap or len(graphs) > graph_cap:
        raise ValueError(
            f"batch exceeds caps: nodes {n_tot}/{node_cap}, "
            f"edges {e_tot}/{edge_cap}, graphs {len(graphs)}/{graph_cap}")
    if flow not in ("source_to_target", "target_to_source"):
        raise ValueError(f"unknown flow {flow!r}")

    def _slim(dt):
        """int64 categorical/count arrays travel as int32: every integer
        feature here is a small vocabulary index or a degree."""
        dt = np.dtype(dt)
        return np.int32 if dt == np.int64 else dt

    g0 = graphs[0]
    dx = g0["x"].shape[1:] if g0["x"].ndim > 1 else ()
    x = np.zeros((node_cap,) + dx, dtype=_slim(g0["x"].dtype))
    edge_index = np.zeros((2, edge_cap), dtype=np.int32)
    batch_vec = np.zeros(node_cap, dtype=np.int32)
    node_mask = np.zeros(node_cap, dtype=bool)
    edge_mask = np.zeros(edge_cap, dtype=bool)
    graph_mask = np.zeros(graph_cap, dtype=bool)

    deg_shape = g0["degrees"].shape[1:] if g0["degrees"].ndim > 1 else ()
    degrees = np.zeros((node_cap,) + deg_shape,
                       dtype=_slim(g0["degrees"].dtype))

    has_ids = "identifiers" in g0 and g0["identifiers"] is not None
    has_ef = "edge_features" in g0 and g0["edge_features"] is not None
    id_on_edges = False
    identifiers = None
    if has_ids:
        k = g0["identifiers"].shape[1]
        id_on_edges = g0["identifiers"].shape[0] == g0["edge_index"].shape[1] \
            and g0["identifiers"].shape[0] != g0["x"].shape[0]
        # ambiguous when n == e for the first graph; disambiguate via flag
        id_on_edges = bool(g0.get("ids_on_edges", id_on_edges))
        id_rows = edge_cap if id_on_edges else node_cap
        identifiers = np.zeros((id_rows, k),
                               dtype=_slim(g0["identifiers"].dtype))
    edge_features = None
    if has_ef:
        ef_shape = g0["edge_features"].shape[1:]
        edge_features = np.zeros((edge_cap,) + ef_shape,
                                 dtype=_slim(g0["edge_features"].dtype))

    y = np.zeros((graph_cap,) + y_shape, dtype=y_dtype)

    has_neig = g0.get("node_eig") is not None
    has_eeig = g0.get("edge_eig") is not None
    node_eig = (np.zeros((node_cap, g0["node_eig"].shape[1]), np.float32)
                if has_neig else None)
    edge_eig = (np.zeros((edge_cap, g0["edge_eig"].shape[1]), np.float32)
                if has_eeig else None)

    n_off, e_off = 0, 0
    for gi, g in enumerate(graphs):
        n, e = g["x"].shape[0], g["edge_index"].shape[1]
        x[n_off:n_off + n] = g["x"]
        edge_index[:, e_off:e_off + e] = g["edge_index"] + n_off
        batch_vec[n_off:n_off + n] = gi
        node_mask[n_off:n_off + n] = True
        edge_mask[e_off:e_off + e] = True
        graph_mask[gi] = True
        degrees[n_off:n_off + n] = g["degrees"]
        if has_ids:
            ids = g["identifiers"]
            if id_on_edges:
                identifiers[e_off:e_off + e] = ids
            else:
                identifiers[n_off:n_off + n] = ids
        if has_ef:
            edge_features[e_off:e_off + e] = g["edge_features"]
        if has_neig:
            node_eig[n_off:n_off + n] = g["node_eig"]
        if has_eeig:
            edge_eig[e_off:e_off + e] = g["edge_eig"]
        yg = np.asarray(g["y"])
        y[gi] = yg.reshape(y_shape) if y_shape else yg.reshape(())
        n_off += n
        e_off += e

    # segment layout: real edges stably sorted by receiver, padding after
    select = 0 if flow == "target_to_source" else 1
    order = np.argsort(edge_index[select, :e_tot], kind="stable")
    perm = np.concatenate([order, np.arange(e_tot, edge_cap)])
    edge_index = np.ascontiguousarray(edge_index[:, perm])
    if has_ef:
        edge_features = edge_features[perm]
    if has_ids and id_on_edges:
        identifiers = identifiers[perm]
    if has_eeig:
        edge_eig = edge_eig[perm]
    recv = edge_index[select, :e_tot]
    send = edge_index[1 - select, :e_tot]
    send_perm = np.argsort(send, kind="stable").astype(np.int32)

    return GraphBatch(
        x=x, edge_index=edge_index, batch=batch_vec, y=y,
        node_mask=node_mask, edge_mask=edge_mask, graph_mask=graph_mask,
        degrees=degrees,
        recv_ptr=_csr(recv, node_cap),
        send_perm=send_perm,
        send_ptr=_csr(send, node_cap),
        graph_ptr=_csr(batch_vec[:n_tot], graph_cap),
        in_degree=np.bincount(recv, minlength=node_cap).astype(np.float32),
        identifiers=identifiers, edge_features=edge_features,
        node_eig=node_eig, edge_eig=edge_eig, flow=flow)
