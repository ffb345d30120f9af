"""The training engine over a process group (counterpart of
``gsn_tpu/parallel/trainer.py``): ``train/loop.py``'s ``Trainer`` (fit,
evaluate, checkpoints, Plateau) with the ``dp`` or ``ep`` step of
``parallel/dp.py`` / ``parallel/ep.py``.

- **dp**: each global batch of ``batch_size`` graphs is dealt
  round-robin into one padded shard per rank (each rank builds its
  own); the last batch of an epoch may hold fewer graphs than ranks, and
  an empty rank then takes an all-padding shard.  BN statistics and the
  loss are global, so the trajectory is the single-device trainer's on
  the same batches up to float reassociation.
- **ep**: each single-device batch is edge-partitioned with
  ``make_ep_batch`` (the node cap rounded up to a multiple of the rank
  count); pools and BN sum over the ranks and the loss is replicated.

Eval counts are summed over dp ranks, not over ep ranks (whose
graph-level rows are replicated); the ROC-AUC pack gathers every dp
rank's predictions.  Every rank reads checkpoints; the caller lets only
rank 0 write them (``cli.py``).  Every dp shard of a batch has the same
caps and there is no per-shard kernel metadata, so no batch leaves the
kernel path (the reference drops shards whose slab metadata differ to
its XLA path, ``gsn_tpu/parallel/trainer.py:288-302``).

The reference's ``distributed`` keyword (separately launched
processes, ``parallel/distributed.py``) is accepted and ignored: a
process of the port is one rank, and a rank already builds only its own
shard (``dp_shard``, ``make_ep_batch(rank=r)``), which is what the
reference's multi-process feeding adds.  So those epochs stay graphed
(below): the reference scans no multi-process epoch
(``gsn_tpu/parallel/trainer.py:82-86``) only because its global
batches, built from process-local rows, cannot be stacked.  The kernels
stay on (the reference turns its kernel layout off there,
``gsn_tpu/parallel/trainer.py:97-103``, because its processes cannot
agree on slab metadata; the port has none).

Epochs run as the single-device trainer's do (``train/loop.py``): with
``scan_epochs`` (the default) each run of same-shape batches replays one
CUDA graph of the whole step on each rank, its collectives (the loss's
and the BN moments' all-reduces, the ep all-gathers and their
reduce-scatters, the gradient sum) captured with it, as the reference's
scanned epochs run under ``shard_map``
(``gsn_tpu/parallel/trainer.py:128-134, 163-176``).  Replayed
collectives pair up only if every rank replays the same graphs in the
same order: every dp shard of a batch is built at the same caps, every
ep shard at one edge slot count with a high-water mark carried across
batches (``_ep_ecap``), and before an epoch's or an evaluation's first
run the ranks compare a digest of its signatures (a host all-gather
over ``collectives.host_group``) and raise if they differ; so a rank
builds its whole epoch before the first replay, where the
single-device trainer builds each batch while the replays before it
run.  An
evaluation's counts and metric sums are all-reduced on the device, and
under dp its evaluator rows are all-gathered there, so a split is still
read once.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from gsn_tpu_torch.graphs.batching import epoch_caps, iterate_batches
from gsn_tpu_torch.graphs.container import GraphBatch
from gsn_tpu_torch.spans import span
from gsn_tpu_torch.train.graphs import batch_sig
from gsn_tpu_torch.train.loop import Trainer, TrainerConfig, TrainState
from .collectives import (all_gather_rows, all_reduce, broadcast_module,
                          host_group)
from .dp import (backward_replicated, dp_shard, global_mean_loss,
                 rank_generator)
from .ep import ep_edge_slots, make_ep_batch
from .mesh import Mesh, make_mesh


class ParallelTrainer(Trainer):
    """``Trainer`` whose steps run data-parallel (``mode="dp"``) or
    edge-partitioned (``mode="ep"``) over ``mesh`` (by default this
    process group's, its axis named ``mode``): graphed epochs under
    ``tcfg.scan_epochs``, whether the ranks were spawned or launched
    separately (``distributed``, ignored: module docstring)."""

    def __init__(self, model_cfg, tcfg: TrainerConfig,
                 graphs_train: List[Dict], mesh: Optional[Mesh] = None,
                 mode: str = "dp", model: Optional[torch.nn.Module] = None,
                 distributed: bool = False):
        if mode not in ("dp", "ep"):
            raise ValueError(f"parallel mode {mode!r} (want 'dp'|'ep')")
        del distributed   # a process is one rank (module docstring)
        self.mode = mode
        self.mesh = mesh or make_mesh(axis_names=(mode,))
        if self.mesh.axis != mode:
            raise ValueError(f"mesh axis {self.mesh.axis!r}, mode {mode!r}")
        self.axis, self.n_devices = mode, self.mesh.size
        if model is None and hasattr(model_cfg, "bn_axis_name"):
            # BN statistics over the whole batch (SURVEY §7 "BN + DP")
            model_cfg = dataclasses.replace(model_cfg.finalize(),
                                            bn_axis_name=mode)
        super().__init__(model_cfg, tcfg, graphs_train,
                         device=self.mesh.device, model=model)
        D = self.n_devices
        if mode == "dp":
            # each shard's caps: the worst ceil(batch_size/D) graphs
            self.shard_bs = -(-tcfg.batch_size // D)
            self.shard_caps = epoch_caps(graphs_train, self.shard_bs)
        elif self.caps is not None:
            n, e, g = self.caps
            self.caps = (-(-n // D) * D, e, g)
        # the high-water edge slot count of the ep shards (reference
        # gsn_tpu/parallel/trainer.py:110): one shape once it settles
        self._ep_ecap = 0
        # the rows of how many shards an evaluator pack holds
        self._pack_ranks = D if mode == "dp" else 1
        g0 = graphs_train[0]
        ids = g0.get("identifiers")
        self._ids_on_edges = (
            ids is not None
            and ids.shape[0] == g0["edge_index"].shape[1]
            and ids.shape[0] != g0["x"].shape[0])

    # ---- state ---------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """The single-device trainer's state, every rank's model rank 0's
        (the same seed builds the same weights; a broadcast makes sure),
        and the dropout streams of the mode: under dp each rank's own,
        under ep one shared stream and each rank's own for node rows."""
        state = super().init_state(seed)
        broadcast_module(state.model, self.axis)
        dev, rank = self.device, self.mesh.rank
        if self.mode == "dp":
            return dataclasses.replace(
                state, dropout_gen=rank_generator(dev, seed + 1, rank))
        return dataclasses.replace(
            state, node_gen=rank_generator(dev, seed + 1, rank + 1))

    # ---- loss and metrics ----------------------------------------------
    def _step_loss(self, y_hat, data: GraphBatch) -> torch.Tensor:
        loss = self.loss_fn(y_hat, data.y, data.graph_mask)
        if self.mode == "dp":
            return global_mean_loss(loss, data.graph_mask, self.axis)
        return loss   # ep: the pools made y_hat, and the loss, global

    def _backward(self, loss: torch.Tensor, model) -> None:
        backward_replicated(loss, model, self.axis)

    def _eval_sums(self, y_hat, data: GraphBatch):
        n, acc = super()._eval_sums(y_hat, data)
        if self.mode == "ep":
            return n, acc
        # the reference's psum of both (f32 on the device, one call)
        both = all_reduce(torch.stack([n, acc]), self.axis)
        return both[0], both[1]

    def _eval_pack(self, y_hat, data: GraphBatch):
        pack = super()._eval_pack(y_hat, data)
        if self.mode == "ep":
            return pack
        return tuple(all_gather_rows(t.contiguous(), self.axis)
                     for t in pack)

    def _check_runs(self, sigs) -> None:
        """Raise unless every rank holds this epoch's or evaluation's
        signatures (module docstring)."""
        # [batch count, a 63-bit digest of the signatures]
        h = hashlib.sha256(repr(list(sigs)).encode()).digest()
        mine = torch.tensor([len(sigs), int.from_bytes(h[:8], "little") >> 1],
                            dtype=torch.int64)
        every = [torch.empty_like(mine) for _ in range(self.n_devices)]
        dist.all_gather(every, mine, group=host_group())
        if any(not torch.equal(t, mine) for t in every):
            raise RuntimeError(
                f"rank {self.mesh.rank}: the ranks' batch shapes differ "
                f"([count, digest] by rank "
                f"{[t.tolist() for t in every]}); their captured "
                f"collectives would not pair up")

    def _train_runs(self, state: TrainState, seq):
        """The single-device trainer's runs over the epoch's every step,
        built up front (``_train_batches``) and their signatures checked
        across the ranks before the first replay (module docstring)."""
        seq = list(seq)
        with span("train.plan"):
            self._check_runs([batch_sig(b) for b in seq])
        return super()._train_runs(state, seq)

    # ---- batches -------------------------------------------------------
    def _train_batches(self, graphs: List[Dict]) -> List[GraphBatch]:
        """The epoch's shards, every one built now."""
        if self.mode == "ep":
            return self._ep_shards(list(iterate_batches(
                graphs, self.tcfg.batch_size, shuffle=self.tcfg.shuffle,
                rng=self.rng, caps=self.caps, y_shape=self.y_shape,
                y_dtype=self.y_dtype, flow=self.flow)))
        order = np.arange(len(graphs))
        if self.tcfg.shuffle:
            self.rng.shuffle(order)
        bs = self.tcfg.batch_size
        return [self._dp_shard([graphs[j] for j in order[i:i + bs]],
                               self.shard_caps)
                for i in range(0, len(order), bs)]

    def _eval_batches(self, graphs: List[Dict],
                      n_iters: Optional[int]) -> List[GraphBatch]:
        if self.mode == "ep":
            return self._ep_shards(super()._eval_batches(graphs, n_iters))
        caps = tuple(max(a, b) for a, b in zip(
            self.shard_caps, epoch_caps(graphs, self.shard_bs)))
        bs = self.tcfg.batch_size
        starts = list(range(0, len(graphs), bs))
        if n_iters is not None:
            starts = starts[:n_iters]
        return [self._dp_shard(graphs[i:i + bs], caps) for i in starts]

    def _dp_shard(self, chunk: List[Dict], caps) -> GraphBatch:
        return dp_shard(chunk, self.mesh.rank, self.n_devices, caps,
                        self.y_shape, self.y_dtype, self.flow)

    def _ep_shards(self, batches: List[GraphBatch]) -> List[GraphBatch]:
        """This rank's shards of ``batches``, all at one edge slot count:
        the high-water mark raised to the batches' largest first."""
        for data in batches:
            self._ep_ecap = ep_edge_slots(data, self.n_devices,
                                          self._ep_ecap)
        return [make_ep_batch(
            data, self.n_devices, self.axis,
            ids_on_edges=(self._ids_on_edges
                          if data.identifiers is not None else None),
            rank=self.mesh.rank, e_cap=self._ep_ecap) for data in batches]
