"""Separately launched processes joining one group, and per-process batch
feeding (counterpart of ``gsn_tpu/parallel/distributed.py``).

``parallel.launch`` spawns its ranks from one parent; here each process
is started on its own (by hand, by a job scheduler, by ``torchrun``) and
joins the group through a coordinator address, its rank and the world
size.  After ``initialize`` the process is one rank of the group, as a
launched rank is after ``init_rank``, and the same mesh trainers run in
it unchanged.

The reference's processes each own several devices of one global mesh
and feed only their rows of it.  In the port a process owns one rank,
which is one row of the mesh axis: ``make_process_dp_batch`` builds that
rank's round-robin shard and nothing of the others', and
``shard_stacked_batch`` picks the rank's row of ``make_ep_batch``'s
shards.  Side effects (checkpoints, logs) belong to rank 0
(``is_coordinator``).

N processes on one machine, on the CPU:

    python -m gsn_tpu_torch.cli --device cpu ... \\
        --coordinator_address 127.0.0.1:9955 \\
        --num_procs_distributed N --process_id <i>     # i = 0..N-1

or programmatically:

    from gsn_tpu_torch.parallel import distributed
    distributed.initialize("127.0.0.1:9955", N, i)  # before device use
    mesh = distributed.global_mesh("dp")
    shard = distributed.make_process_dp_batch(graphs, mesh, ...)

Without an address the process reads the ``env://`` variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), as
``torchrun`` sets them.  A CUDA process takes card ``LOCAL_RANK`` when
that is set, else card ``process_id`` modulo the cards it sees.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .dp import make_global_batch
from .mesh import DEFAULT_TIMEOUT_S, Mesh, backend_for, make_mesh

ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _rank_and_size(coordinator_address, num_processes, process_id):
    """(init_method, world size, rank), checked."""
    if coordinator_address is None:
        given = {"RANK": process_id, "WORLD_SIZE": num_processes}
        missing = [k for k in ENV_VARS
                   if k not in os.environ and given.get(k) is None]
        if missing:
            raise RuntimeError(
                f"distributed.initialize without a coordinator address "
                f"joins through env:// and needs {', '.join(missing)} in "
                f"the environment (or pass --coordinator_address "
                f"host:port)")
        init_method = "env://"
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs the process "
                             "count and this process's id")
        init_method = f"tcp://{coordinator_address}"
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} of {num_processes} "
                         f"processes: want 0 <= id < count")
    return init_method, num_processes, process_id


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               platform: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this process to the group; returns its device.

    ``coordinator_address`` ``host:port``: rank ``process_id`` of
    ``num_processes`` meets the others there (``tcp://``; rank 0 listens
    on that port).  None: ``env://``.  ``platform="cpu"``: a gloo rank
    on the CPU.  Otherwise an NCCL rank on its card (``LOCAL_RANK``, else
    ``process_id`` modulo the visible cards); with no card it raises, and
    it never carries on over gloo or on the CPU.  Call it before any
    other device use."""
    init_method, world, rank = _rank_and_size(
        coordinator_address, num_processes, process_id)
    if platform == "cpu":
        dev = torch.device("cpu")
    elif platform not in (None, "cuda", "gpu"):
        raise ValueError(f"platform {platform!r} (want cpu or cuda)")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("distributed.initialize: no CUDA device is "
                               "available; pass platform='cpu' (the CLI's "
                               "--device cpu) for a CPU rank")
        local = os.environ.get("LOCAL_RANK")
        card = (int(local) if local is not None
                else rank % torch.cuda.device_count())
        if card >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {card}: "
                               f"{torch.cuda.device_count()} cards visible")
        dev = torch.device("cuda", card)
        torch.cuda.set_device(dev)
    kw = dict(backend=backend_for(dev), init_method=init_method,
              world_size=world, rank=rank,
              timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev


def shutdown() -> None:
    """Leave the group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    """True on the process that owns side effects (checkpoint writes,
    log files): rank 0, or a process outside any group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(axis: str = "dp") -> Mesh:
    """The group's one axis, named ``axis``."""
    return make_mesh(axis_names=(axis,))


def _local_rows(mesh: Mesh, axis: str) -> tuple:
    """(row_start, n_rows) of this process on the mesh axis: its rank,
    and one row."""
    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r}, asked for {axis!r}")
    return mesh.rank, 1


def make_global_batch_from_local(local, mesh: Mesh, axis: str = "dp"):
    """This process's rows of the global batch: its own shard, moved to
    its device (the other rows live in the other processes)."""
    _local_rows(mesh, axis)
    return local.to(mesh.device)


def make_process_dp_batch(graphs: List[Dict], mesh: Mesh,
                          node_cap: int, edge_cap: int, graph_cap: int,
                          axis: str = "dp", y_shape=(),
                          y_dtype=np.int64,
                          flow: str = "source_to_target"):
    """This rank's shard of a data-parallel global batch: graph i goes
    to rank i % D (``parallel/dp.py::make_global_batch``'s round robin),
    and only this rank's graphs are batched.  Every process passes the
    same ``graphs`` list; raises when a rank would get no graph."""
    row, _ = _local_rows(mesh, axis)
    shard = make_global_batch(graphs, mesh.size, node_cap, edge_cap,
                              graph_cap, y_shape=y_shape, y_dtype=y_dtype,
                              flow=flow, rank=row)
    return make_global_batch_from_local(shard, mesh, axis)


def shard_stacked_batch(stacked, mesh: Mesh, axis: str = "ep"):
    """This rank's row of a batch every process splits alike (the list
    of ``make_ep_batch``'s shards), on its device."""
    row, _ = _local_rows(mesh, axis)
    if len(stacked) != mesh.size:
        raise ValueError(f"{len(stacked)} shards on an axis of "
                         f"{mesh.size} ranks")
    return make_global_batch_from_local(stacked[row], mesh, axis)


def fetch_replicated(x):
    """Host value of a tensor every rank holds alike (or a dict, list or
    tuple of them)."""
    if isinstance(x, dict):
        return {k: fetch_replicated(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(fetch_replicated(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
