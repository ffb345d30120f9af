"""Edge-partitioned propagation of one graph over the ranks of an axis
(counterpart of ``gsn_tpu/parallel/edge_partition.py``).

The nodes are split into equal blocks, rank d owning rows
[d·N/D, (d+1)·N/D); the edges are split by receiver, so every message
is summed on the rank of its receiver.  The sender rows reach the
receivers' ranks in one of two ways:

- ``edge_partitioned_propagate``: an all-gather of the node blocks
  (``collectives.all_gather``, whose backward is a reduce-scatter), then
  a gather of the rows per edge;
- ``ring_edge_partitioned_propagate``: the blocks travel round the ring
  of ranks (``collectives.ring_shift``), one hop a step; at hop k rank d
  holds block (d - k) % D and sums the messages of the edges whose
  senders lie in it.  A rank holds two blocks at most.

The partitions return the reference's arrays bit for bit, and beside
them a **CSR layout** per rank (and per hop): ``order``, the rank's
edge slots with the real ones stably sorted by local receiver and the
padding after them, and ``recv_ptr`` [block+1], the receivers' offsets
in that order.  A propagate takes them in place of the reference's
edge mask (the padding slots lie past ``recv_ptr[-1]``), and each sum
of messages is ``receiver_sum`` over ``recv_ptr``: K3 forward and K4
backward on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gsn_tpu_torch.ops.segment import receiver_sum
from .collectives import all_gather, axis_size, ring_shift
from .mesh import Mesh

# the reference's padding of a rank's (or a hop's) edge slots
SLOT_ALIGN = 128


def _slot_cap(n: int) -> int:
    return max(((n + SLOT_ALIGN - 1) // SLOT_ALIGN) * SLOT_ALIGN,
               SLOT_ALIGN)


def _csr_layout(recv_local: np.ndarray, mask: np.ndarray, block: int):
    """(order [D, cap] int64, recv_ptr [D, block+1] int32) of a rank's
    slot arrays: the real slots stably sorted by receiver, then the
    padding slots."""
    D, cap = recv_local.shape
    order = np.empty((D, cap), np.int64)
    recv_ptr = np.zeros((D, block + 1), np.int32)
    for d in range(D):
        real = np.flatnonzero(mask[d])
        real = real[np.argsort(recv_local[d, real], kind="stable")]
        order[d] = np.concatenate([real, np.flatnonzero(~mask[d])])
        np.cumsum(np.bincount(recv_local[d, real], minlength=block),
                  out=recv_ptr[d, 1:])
    return order, recv_ptr


def partition_edges_by_receiver(
    edge_index: np.ndarray,   # [2, E] global node ids (recv row 0)
    num_nodes: int,
    num_devices: int,
    edge_mask: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Rank d gets every edge whose receiver lies in its node block,
    padded to a common slot count (a multiple of 128).  Arrays with a
    leading rank axis: ``recv_local`` [D, Ed] (the receiver's row in the
    block), ``send_global`` [D, Ed] (the sender's global id),
    ``edge_mask`` [D, Ed], and the CSR layout ``order`` [D, Ed] and
    ``recv_ptr`` [D, block+1]; ``node_block`` the block's rows."""
    if num_nodes % num_devices:
        raise ValueError("num_nodes must be divisible by num_devices "
                         "(pad the node dimension to a multiple)")
    block = num_nodes // num_devices
    recv, send = edge_index[0], edge_index[1]
    if edge_mask is None:
        edge_mask = np.ones(edge_index.shape[1], dtype=bool)
    D = num_devices
    sels = [(recv // block == d) & edge_mask for d in range(D)]
    cap = _slot_cap(max(int(s.sum()) for s in sels))
    recv_local = np.zeros((D, cap), np.int32)
    send_global = np.zeros((D, cap), np.int32)
    mask = np.zeros((D, cap), bool)
    for d, sel in enumerate(sels):
        n = int(sel.sum())
        recv_local[d, :n] = recv[sel] - d * block
        send_global[d, :n] = send[sel]
        mask[d, :n] = True
    order, recv_ptr = _csr_layout(recv_local, mask, block)
    return {"recv_local": recv_local, "send_global": send_global,
            "edge_mask": mask, "node_block": block, "order": order,
            "recv_ptr": recv_ptr}


def partition_edges_ring(
    edge_index: np.ndarray,    # [2, E] global ids, recv row 0
    num_nodes: int,
    num_devices: int,
) -> Dict[str, tuple]:
    """Each rank's received edges bucketed by the sender's block: hop k
    on rank d takes bucket (d, (d - k) % D), the edges whose senders lie
    in the block d holds then, in edge order.  Each hop has its own slot
    count, the largest of its buckets over the ranks rounded up to a
    multiple of 128 (disjoint-union batches put nearly every edge in
    hop 0).  Tuples of D per-hop arrays [D, cap_k]: ``recv_local``,
    ``send_local`` (the sender's row in its block), ``edge_mask``,
    ``order``, and ``recv_ptr`` [D, block+1]; ``node_block``."""
    if num_nodes % num_devices:
        raise ValueError("num_nodes must be divisible by num_devices")
    block = num_nodes // num_devices
    recv, send = edge_index[0], edge_index[1]
    D = num_devices
    # bucket (d, s) = the edges of receiver block d and sender block s,
    # in edge order (a stable sort by bucket)
    bucket = (recv // block) * D + send // block
    by_bucket = np.argsort(bucket, kind="stable")
    starts = np.concatenate([[0], np.cumsum(
        np.bincount(bucket, minlength=D * D))])

    out = {"recv_local": [], "send_local": [], "edge_mask": [],
           "order": [], "recv_ptr": []}
    for k in range(D):
        idxs = [by_bucket[starts[d * D + (d - k) % D]:
                          starts[d * D + (d - k) % D + 1]]
                for d in range(D)]
        cap = _slot_cap(max(len(i) for i in idxs))
        rl = np.zeros((D, cap), np.int32)
        sl = np.zeros((D, cap), np.int32)
        m = np.zeros((D, cap), bool)
        for d, idx in enumerate(idxs):
            n = len(idx)
            rl[d, :n] = recv[idx] - d * block
            sl[d, :n] = send[idx] - ((d - k) % D) * block
            m[d, :n] = True
        order, recv_ptr = _csr_layout(rl, m, block)
        for key, arr in (("recv_local", rl), ("send_local", sl),
                         ("edge_mask", m), ("order", order),
                         ("recv_ptr", recv_ptr)):
            out[key].append(arr)
    out = {key: tuple(arrs) for key, arrs in out.items()}
    out["node_block"] = block
    return out


def rank_inputs(parts: Dict, rank: int, device) -> tuple:
    """Rank ``rank``'s edge arguments of a propagate, as tensors on
    ``device``: (receivers, senders, order, recv_ptr), each a tensor for
    ``partition_edges_by_receiver``'s parts and a tuple of per-hop
    tensors for ``partition_edges_ring``'s."""
    send_key = "send_global" if "send_global" in parts else "send_local"

    def row(a):
        if isinstance(a, tuple):
            return tuple(row(h) for h in a)
        return torch.from_numpy(np.ascontiguousarray(a[rank])).to(device)

    return tuple(row(parts[k]) for k in ("recv_local", send_key, "order",
                                         "recv_ptr"))


def _message_sum(message_fn, x_recv, x_send, recv, send, order, recv_ptr):
    """Σ over this rank's edges of message_fn(x_recv[recv],
    x_send[send]) into the receivers' rows: the messages in the CSR
    order, summed by ``receiver_sum`` over ``recv_ptr``."""
    msgs = message_fn(x_recv[recv.long()[order]],
                      x_send[send.long()[order]])
    return receiver_sum(msgs, recv_ptr)


def edge_partitioned_propagate(
    mesh: Mesh,
    message_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    axis: str = "ep",
):
    """A propagate run inside each rank of ``mesh``:

    ``out[v] = Σ_{e: recv(e)=v} message_fn(x[recv(e)], x[send(e)])``

    for the rows v of this rank's block.  The callable takes
    ``(x_shard [block, d], recv_local [Ed], send_global [Ed], order
    [Ed], recv_ptr [block+1])``, this rank's row of
    ``partition_edges_by_receiver``'s arrays (``rank_inputs``), and
    returns [block, dm].  ``message_fn`` maps ([Ed, d] x_i, [Ed, d] x_j)
    to [Ed, dm]."""
    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r}, asked for {axis!r}")

    def local(x_shard, recv_local, send_global, order, recv_ptr):
        x_full = all_gather(x_shard, axis)
        return _message_sum(message_fn, x_shard, x_full, recv_local,
                            send_global, order, recv_ptr)

    return local


def ring_edge_partitioned_propagate(
    mesh: Mesh,
    message_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    axis: str = "ep",
):
    """The propagate of ``edge_partitioned_propagate`` with the node
    blocks travelling round the ring: D hops, unrolled, each summing the
    edges whose senders lie in the block held, then (but for the last)
    passing the block on to rank r+1.  The callable takes ``(x_shard,
    recvs, sends, orders, recv_ptrs)``, each a sequence of this rank's D
    per-hop rows of ``partition_edges_ring``'s arrays (``rank_inputs``).
    Its gradient sends each hop's cotangent back the way the block came
    (``collectives.ring_shift``)."""
    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r}, asked for {axis!r}")

    def local(x_shard, recvs, sends, orders, recv_ptrs):
        D = len(recvs)
        if D != axis_size(axis):
            raise ValueError(f"{D} hops on an axis of {axis_size(axis)} "
                             f"ranks")
        agg, held = None, x_shard
        for k in range(D):
            part = _message_sum(message_fn, x_shard, held, recvs[k],
                                sends[k], orders[k], recv_ptrs[k])
            agg = part if agg is None else agg + part
            if k < D - 1:   # the last hop passes nothing on
                held = ring_shift(held, axis)
        return agg

    return local


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scaling_efficiency_bench(
    mesh: Mesh,
    num_nodes: int = 8192,
    avg_degree: int = 8,
    d: int = 128,
    iters: int = 20,
    seed: int = 0,
):
    """Edges/s of the all-gather propagate over ``mesh`` (run inside
    each rank; this rank's time) and of one device's propagate of the
    same graph (``receiver_sum`` over the receiver-sorted edges), with
    the message ``x_i·0.5 + x_j``."""
    rng = np.random.RandomState(seed)
    D, rank, dev = mesh.size, mesh.rank, mesh.device
    E = num_nodes * avg_degree
    edge_index = np.stack([rng.randint(0, num_nodes, E),
                           rng.randint(0, num_nodes, E)]).astype(np.int64)
    x = rng.randn(num_nodes, d).astype(np.float32)

    def message(xi, xj):
        return xi * 0.5 + xj

    parts = partition_edges_by_receiver(edge_index, num_nodes, D)
    block = parts["node_block"]
    prop = edge_partitioned_propagate(mesh, message, mesh.axis)
    xs = torch.from_numpy(x[rank * block:(rank + 1) * block]).to(dev)
    args = rank_inputs(parts, rank, dev)

    def rate(fn):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(dev)
        return E / ((time.perf_counter() - t0) / iters)

    dist_rate = rate(lambda: prop(xs, *args))

    by_recv = np.argsort(edge_index[0], kind="stable")
    r = torch.from_numpy(edge_index[0, by_recv]).to(dev)
    s = torch.from_numpy(edge_index[1, by_recv]).to(dev)
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(np.bincount(
        edge_index[0], minlength=num_nodes))]).astype(np.int32)).to(dev)
    x_all = torch.from_numpy(x).to(dev)
    single_rate = rate(lambda: receiver_sum(message(x_all[r], x_all[s]),
                                            ptr))
    return {"edges": E, "devices": D, "dist_edges_per_s": dist_rate,
            "single_edges_per_s": single_rate}
