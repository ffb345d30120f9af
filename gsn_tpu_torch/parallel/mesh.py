"""Process groups as device meshes (counterpart of
``gsn_tpu/parallel/mesh.py``).

The reference's mesh is a 1-D array of the devices of one process, with
an axis name (``dp`` or ``ep``) that ``shard_map`` and the collectives
read.  Here every device is driven by a process of its own: ``launch``
spawns one process per rank and joins them in a ``torch.distributed``
group, and ``make_mesh`` (called inside a rank) names that group's one
axis and returns what a trainer needs to know of it.

Backends: gloo for CPU ranks, NCCL for CUDA ranks (rank r on card r).
A CUDA run that cannot get NCCL raises; it never carries on over gloo
or on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a rank waits on a collective, and launch() on its ranks
DEFAULT_TIMEOUT_S = 120


@dataclasses.dataclass
class Mesh:
    """One named axis over the ranks of this process's group."""
    axis: str                  # "dp" or "ep"
    size: int                  # ranks on the axis
    rank: int                  # this process's rank
    device: torch.device       # this rank's device


def backend_for(device) -> str:
    """gloo for the CPU, NCCL for a CUDA card; raise when a CUDA run
    cannot have NCCL."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"parallel runs take cpu or cuda devices, got "
                         f"{device}")
    if not (dist.is_available() and dist.is_nccl_available()):
        raise RuntimeError("a CUDA parallel run needs NCCL, which this "
                           "torch does not have")
    return "nccl"


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or card ``rank``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank)
    return device


def init_rank(rank: int, world_size: int, device, init_file: str,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this process to the group through the rendezvous file
    ``init_file``; returns the rank's device."""
    dev = rank_device(device, rank)
    backend = backend_for(dev)
    if dev.type == "cuda":
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} has no card: "
                               f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, init_method=f"file://{init_file}",
              world_size=world_size, rank=rank,
              timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev


def make_mesh(num_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",)) -> Mesh:
    """The mesh of this process's group, its axis named
    ``axis_names[0]``.  Call it inside a rank (see ``launch``);
    ``num_devices``, when given, must be the group's size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run inside "
                           "parallel.launch (or init_rank)")
    if len(axis_names) != 1:
        raise ValueError(f"the port's meshes have one axis, got "
                         f"{tuple(axis_names)}")
    size, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"requested {num_devices} devices, the group "
                         f"has {size} ranks")
    backend = dist.get_backend()
    device = (torch.device("cuda", torch.cuda.current_device())
              if backend == "nccl" else torch.device("cpu"))
    return Mesh(axis=axis_names[0], size=size, rank=rank, device=device)


def _rank_main(rank, world_size, device, init_file, out_dir, timeout_s,
               fn, args):
    torch.set_num_threads(1)
    init_rank(rank, world_size, device, init_file, timeout_s)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, num_ranks: int, device=None,
           args: Sequence = (), timeout_s: float = DEFAULT_TIMEOUT_S
           ) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``num_ranks`` spawned processes joined
    in one group (gloo on the CPU, NCCL on cards 0..num_ranks-1) and
    return each rank's result, in rank order (``torch.save``-able
    values).  ``device``: ``"cpu"`` or ``"cuda"``; by default the cards,
    and with no card the call raises rather than run on the CPU.  The
    group meets through a ``file://`` rendezvous in a new
    temporary directory, so concurrent launches never share a port.  Ranks that have not ended after
    ``timeout_s`` seconds are killed and the call raises; so does a rank
    that raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("launch: no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        device = "cuda"
    device = torch.device(device)
    backend_for(device)
    if device.type == "cuda" and num_ranks > torch.cuda.device_count():
        raise ValueError(f"{num_ranks} CUDA ranks, "
                         f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(num_ranks, str(device), init_file, tmp,
                              timeout_s, fn, tuple(args)),
            nprocs=num_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: ranks still running "
                                       f"after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(num_ranks)]
