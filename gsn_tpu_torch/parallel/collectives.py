"""Differentiable collectives over a named mesh axis.

The reference runs its parallel layer under ``shard_map``, where
``lax.psum`` / ``lax.all_gather`` name a mesh axis and autodiff
transposes them.  Here each rank is a process of a
``torch.distributed`` group, and a mesh has one axis over all of them;
the model's modules name that axis as the reference's do
(``bn_axis_name``, ``GraphBatch.ep_axis``: ``"dp"`` or ``"ep"``), and
the collectives run over this process's group.

The gradient convention: every rank runs ``backward()`` on its own
copy of the loss, and the parameters' gradients are summed over the
ranks afterwards (``all_reduce_grads``).  So:

- ``all_reduce`` sums a tensor over the ranks; its backward sums the
  cotangents (each rank's use of the sum is a different use);
- ``all_gather`` stacks the ranks' row blocks; its backward is a
  reduce-scatter, summing every rank's cotangent of a block into the
  rank that owns it (``jax.lax.all_gather(..., tiled=True)``'s
  transpose);
- a loss that every rank computes identically (the replicated loss of
  edge partitioning, the global mean of data parallelism) is divided by
  the world size before ``backward()``, or the sum of the parameters'
  gradients counts it once per rank.

``torch.distributed.nn.functional`` has these Functions too, but it is
deprecated.  The gather and the reduce-scatter call
``all_gather_single`` / ``reduce_scatter_single`` where torch has them
(the names that replace ``all_gather_into_tensor`` /
``reduce_scatter_tensor``), else the older names.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

_gather_into = (getattr(dist, "all_gather_single", None)
                or dist.all_gather_into_tensor)
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


def axis_size(axis: str) -> int:
    """The ranks of mesh axis ``axis``: this process's group (a mesh has
    one axis, over every rank); raise outside a process group."""
    if not dist.is_initialized():
        raise RuntimeError(f"mesh axis {axis!r} has no process group: run "
                           f"inside parallel.launch (or init_rank)")
    return dist.get_world_size()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        axis_size(axis)
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.size = axis_size(axis)
        x = x.contiguous()
        out = x.new_empty((ctx.size * x.shape[0],) + tuple(x.shape[1:]))
        _gather_into(out, x)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // ctx.size,) + tuple(g.shape[1:]))
        _reduce_scatter(out, g)
        return out, None


def _permute(x: torch.Tensor, shift: int) -> torch.Tensor:
    """This rank's ``x`` sent to rank ``r + shift`` and the one of rank
    ``r - shift`` received (mod the world size), the send and the
    receive posted in one batch (posted apart, gloo and NCCL can
    deadlock)."""
    size, rank = dist.get_world_size(), dist.get_rank()
    x = x.contiguous()
    if size == 1:
        return x.clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank + shift) % size),
           dist.P2POp(dist.irecv, out, (rank - shift) % size)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        axis_size(axis)
        return _permute(x, 1)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, -1), None


def ring_shift(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Rank ``r - 1``'s ``x`` (mod the world size): every rank sends its
    ``x`` one step round the ring (``jax.lax.ppermute`` with the pairs
    ``(i, i + 1)``); differentiable, its backward sends each cotangent
    one step back."""
    return _RingShift.apply(x, axis)


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Σ over the ranks of axis ``axis``; differentiable (see module
    docstring)."""
    return _AllReduce.apply(x, axis)


def all_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The ranks' ``x`` [n, ...] stacked in rank order into
    [size·n, ...] (each rank's rows the same count); differentiable, its
    backward a reduce-scatter."""
    return _AllGather.apply(x, axis)


def all_gather_rows(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``all_gather`` outside autograd (predictions, labels, masks);
    bool tensors travel as uint8."""
    with torch.no_grad():
        if x.dtype == torch.bool:
            return all_gather(x.to(torch.uint8), axis).bool()
        return all_gather(x, axis)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], axis: str,
                     ) -> None:
    """Sum the parameters' gradients over the ranks, in one flat buffer.
    Parameters without a gradient keep none (every rank runs the same
    modules, so the ranks agree on which have one)."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    axis_size(axis)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    off = 0
    for p in params:
        p.grad.copy_(flat[off:off + p.numel()].view_as(p))
        off += p.numel()


def broadcast_module(module: torch.nn.Module, axis: str,
                     src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers into every rank's."""
    axis_size(axis)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src)


# (the default group, the gloo group made beside it): see host_group
_host = (None, None)


def host_group():
    """A group over every rank for host (CPU) tensors: the default group
    where it is gloo, else one gloo group per default group, made at the
    first call (every rank makes it) and released with the default group
    by ``destroy_process_group`` (``distributed.shutdown``, ``launch``'s
    ranks)."""
    global _host
    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    if _host[0] is not world:
        _host = (world, dist.new_group(backend="gloo"))
    return _host[1]
