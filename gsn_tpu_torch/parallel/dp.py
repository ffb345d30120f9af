"""Data-parallel training over a process group (counterpart of
``gsn_tpu/parallel/dp.py``).

The graphs of a global batch are dealt round-robin to the ranks; each
rank builds only its own padded shard.  Every rank runs the model on its
shard; masked BatchNorm sums its moments over the ``dp`` axis
(``bn_axis_name="dp"``), so the statistics are the whole batch's, as in
the reference's single-device BN (SURVEY §7 "BN + DP").  The loss is
the global graph-weighted mean ``Σ_r loss_r·n_r / max(Σ_r n_r, 1)``,
formed inside the differentiated function (the BN moments couple the
shards, so a local loss would miss the cross-shard terms), and the
parameters' gradients are summed over the ranks once after
``backward()`` (``collectives.backward_replicated``).  Every rank starts
from rank 0's weights and draws its dropout masks from its own stream
(the reference's ``fold_in(key, axis_index("dp"))``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from gsn_tpu_torch.graphs.container import GraphBatch, batch_graphs, \
    mask_off
from gsn_tpu_torch.nn.models import build_model
from gsn_tpu_torch.train.loop import TrainState, full_f32_matmuls
from gsn_tpu_torch.train.metrics import LOSSES
from gsn_tpu_torch.train.optim import make_optimizer, set_lr
from .collectives import (all_reduce, all_reduce_grads, axis_size,
                          broadcast_module)
from .mesh import Mesh

# seed stride between the ranks' own dropout streams
RANK_SEED_STRIDE = 0x9E3779B1


def rank_generator(device, seed: int, rank: int) -> torch.Generator:
    """A dropout generator on ``device`` for rank ``rank``'s own stream
    (rank 0's is the single-device trainer's, seeded ``seed``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + RANK_SEED_STRIDE * rank)
    return gen


def make_global_batch(graphs: List[Dict], num_devices: int,
                      node_cap: int, edge_cap: int, graph_cap: int,
                      y_shape=(), y_dtype=np.int64,
                      flow: str = "source_to_target",
                      rank: Optional[int] = None):
    """Deal ``graphs`` round-robin into ``num_devices`` shards, each
    padded to the same caps: the list of shards, or with ``rank`` only
    that rank's (each rank builds its own).  Raises when a shard would
    be empty."""
    per_dev = [graphs[d::num_devices] for d in range(num_devices)]
    if not all(per_dev):
        raise ValueError(f"need >= {num_devices} graphs per global batch, "
                         f"got {len(graphs)}")
    ranks = range(num_devices) if rank is None else [rank]
    shards = [batch_graphs(per_dev[r], node_cap, edge_cap, graph_cap,
                           y_shape=y_shape, y_dtype=y_dtype, flow=flow)
              for r in ranks]
    return shards if rank is None else shards[0]


def dp_shard(chunk: List[Dict], rank: int, num_devices: int, caps,
             y_shape=(), y_dtype=np.int64,
             flow: str = "source_to_target") -> GraphBatch:
    """Rank ``rank``'s round-robin shard of ``chunk``; when the chunk has
    fewer graphs than ranks, an empty rank takes an all-padding shard
    (``mask_off`` of the chunk's first graph)."""
    mine = chunk[rank::num_devices]
    shard = batch_graphs(mine or chunk[:1], *caps, y_shape=y_shape,
                         y_dtype=y_dtype, flow=flow)
    return shard if mine else mask_off(shard)


def global_mean_loss(loss: torch.Tensor, graph_mask: torch.Tensor,
                     axis: str) -> torch.Tensor:
    """``Σ_r loss_r·n_r / max(Σ_r n_r, 1)`` over the ranks of ``axis``
    (n_r the rank's real graphs), differentiable.  Written as the sum of
    ``loss_r·(n_r / N)``, so one rank gets its own loss bit for bit."""
    n = graph_mask.sum().to(torch.float32)
    total = torch.clamp(all_reduce(n, axis), min=1.0)
    return all_reduce(loss * (n / total), axis)


def backward_replicated(loss: torch.Tensor, model: torch.nn.Module,
                        axis: str) -> None:
    """``backward()`` of a loss that every rank of ``axis`` holds alike,
    then the gradients summed over the ranks: the loss is divided by the
    world size first, or the sum would count it once per rank
    (``collectives`` module docstring)."""
    (loss / axis_size(axis)).backward()
    all_reduce_grads(model.parameters(), axis)


class MeshTrainer:
    """Step-level trainer over a mesh: the state, one train step and the
    gradients of one step (for parity tests), shared by the ``dp`` and
    ``ep`` trainers.  ``model_cfg``'s BN statistics are summed over the
    mesh axis."""

    def __init__(self, model_cfg, mesh: Mesh, lr: float = 1e-3,
                 weight_decay: float = 0.0,
                 loss_fn: str = "CrossEntropyLoss"):
        full_f32_matmuls()
        self.mesh, self.axis = mesh, mesh.axis
        self.model_cfg = dataclasses.replace(model_cfg.finalize(),
                                             bn_axis_name=mesh.axis)
        self.lr, self.weight_decay = lr, weight_decay
        self.loss_fn = LOSSES[loss_fn]

    def init_state(self, seed: int = 0) -> TrainState:
        """Weights drawn from ``seed`` and then rank 0's broadcast, on
        this rank's device; the dropout generators as ``generators``."""
        model = build_model(self.model_cfg,
                            torch.Generator().manual_seed(seed))
        model = model.to(self.mesh.device)
        broadcast_module(model, self.axis)
        opt = make_optimizer(model.parameters(), self.lr, self.weight_decay,
                             self.mesh.device)
        drop, node = self.generators(seed + 1)
        return TrainState(model=model, optimizer=opt, dropout_gen=drop,
                          node_gen=node)

    def generators(self, seed: int):
        """(dropout generator, node stream or None): under dp each rank's
        own stream."""
        return rank_generator(self.mesh.device, seed, self.mesh.rank), None

    def loss(self, y_hat, data: GraphBatch) -> torch.Tensor:
        """The global mean loss (``global_mean_loss``)."""
        return global_mean_loss(self.loss_fn(y_hat, data.y,
                                             data.graph_mask),
                                data.graph_mask, self.axis)

    def _loss_and_backward(self, state: TrainState, data: GraphBatch):
        data = data.to(self.mesh.device)
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(model(data, state.generators), data)
        backward_replicated(loss, model, self.axis)
        return loss.detach()

    def train_step(self, state: TrainState, shard: GraphBatch,
                   lr: Optional[float] = None):
        """One Adam step on this rank's shard; (state, global loss)."""
        set_lr(state.optimizer, self.lr if lr is None else lr)
        loss = self._loss_and_backward(state, shard)
        state.optimizer.step()
        return state, loss

    def grads(self, state: TrainState, shard: GraphBatch
              ) -> Dict[str, torch.Tensor]:
        """The global loss's gradients by parameter name (the running BN
        statistics move as in a step; the weights do not)."""
        self._loss_and_backward(state, shard)
        return {name: p.grad.detach().clone()
                for name, p in state.model.named_parameters()}


class DataParallelTrainer(MeshTrainer):
    """Data-parallel train steps over the ``dp`` axis (reference
    ``gsn_tpu/parallel/dp.py::DataParallelTrainer``)."""
