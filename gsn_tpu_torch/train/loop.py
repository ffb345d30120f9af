"""Training / evaluation engine (counterpart of
``gsn_tpu/train/loop.py``).

Ported so far: ``Trainer.__init__`` (with the reference's ``model=``),
``init_state``, ``train_step`` and ``evaluate`` (with the ``rocauc``
evaluator).  The epoch loop (``fit``) and checkpoints wait for a later
slice.

The trainer runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit device it raises rather
than fall back.  On the card the hand-written kernels run; on the CPU
their plain PyTorch versions do.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from gsn_tpu_torch.graphs.batching import (epoch_caps, infer_y_spec,
                                           iterate_batches,
                                           tight_epoch_caps)
from gsn_tpu_torch.graphs.container import GraphBatch
from gsn_tpu_torch.nn.init import init_parameters
from gsn_tpu_torch.nn.models import build_model
from .metrics import LOSSES, PREDICTION_FNS, roc_auc_score
from .optim import make_optimizer, make_scheduler


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA card; raise when there is none
    (CPU runs must ask for the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


def full_f32_matmuls() -> None:
    """f32 products in full f32 on the card (no TF32): the port's
    tolerances against the reference assume it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    dropout_gen: torch.Generator   # dropout masks, on the model's device
    epoch: int = 0


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 0.01
    regularization: float = 0.0           # Adam weight_decay
    scheduler: str = "StepLR"
    decay_steps: int = 50
    decay_rate: float = 0.5
    batch_size: int = 16
    loss_fn: str = "CrossEntropyLoss"
    prediction_fn: str = "multi_class_accuracy"
    evaluator: Optional[str] = None       # None | "rocauc"


class Trainer:
    """Owns the model config, loss, scheduler and batching policy; the
    model and optimizer live in the ``TrainState`` from ``init_state``.

    ``model`` (as in the reference trainer) is a module to train in
    place of ``build_model(model_cfg)``, e.g. ``DGNNet(cfg)``; each
    ``init_state`` trains a copy of it with fresh weights."""

    def __init__(self, model_cfg, tcfg: TrainerConfig,
                 graphs_train: List[Dict], device=None,
                 model: Optional[torch.nn.Module] = None):
        self.device = resolve_device(device)
        full_f32_matmuls()
        self.model_cfg = (model_cfg.finalize()
                          if hasattr(model_cfg, "finalize") else model_cfg)
        self.model = model
        self.tcfg = tcfg
        self.loss_fn = LOSSES[tcfg.loss_fn]
        self.pred_fn = PREDICTION_FNS.get(tcfg.prediction_fn)
        self.scheduler = make_scheduler(
            tcfg.scheduler, tcfg.lr, tcfg.decay_steps, tcfg.decay_rate)
        # one shape for every batch: the worst-case caps of the train set
        self.caps = epoch_caps(graphs_train, tcfg.batch_size)
        self.y_shape, self.y_dtype = infer_y_spec(graphs_train)
        self.flow = getattr(self.model_cfg, "flow", "source_to_target")

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh weights drawn from ``torch.Generator`` seeded with
        ``seed``, on the trainer's device, with a new optimizer; the
        dropout masks come from a generator on that device seeded with
        ``seed + 1`` (the reference's dropout key)."""
        gen = torch.Generator().manual_seed(seed)
        if self.model is None:
            model = build_model(self.model_cfg, gen)
        else:
            model = copy.deepcopy(self.model)
            init_parameters(model, gen)
        model = model.to(self.device)
        opt = make_optimizer(model.parameters(), self.tcfg.lr,
                             self.tcfg.regularization)
        dropout_gen = torch.Generator(device=self.device)
        dropout_gen.manual_seed(seed + 1)
        return TrainState(model=model, optimizer=opt,
                          dropout_gen=dropout_gen)

    def to_device(self, data: GraphBatch) -> GraphBatch:
        """A host-built (numpy) batch moved to the trainer's device."""
        if isinstance(data.x, np.ndarray):
            return data.to(self.device)
        return data

    def train_step(self, state: TrainState, data: GraphBatch,
                   lr: Optional[float] = None):
        """One Adam step on ``data``; returns (state, detached loss).
        ``lr`` defaults to the scheduler's current rate."""
        data = self.to_device(data)
        model, opt = state.model, state.optimizer
        model.train()
        for group in opt.param_groups:
            group["lr"] = self.scheduler.lr if lr is None else lr
        opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(model(data, state.dropout_gen), data.y,
                            data.graph_mask)
        loss.backward()
        opt.step()
        return state, loss.detach()

    def _eval_batches(self, graphs: List[Dict],
                      n_iters: Optional[int]) -> List[GraphBatch]:
        # the caps come from the TRAIN split; a skewed eval split can
        # exceed them, so take the elementwise max with this split's own
        # tight caps
        tight = tight_epoch_caps(np.arange(len(graphs)), graphs,
                                 self.tcfg.batch_size)
        caps = tuple(max(a, b) for a, b in zip(self.caps, tight))
        batches = []
        for it_idx, data in enumerate(iterate_batches(
                graphs, self.tcfg.batch_size, shuffle=False, caps=caps,
                y_shape=self.y_shape, y_dtype=self.y_dtype,
                flow=self.flow)):
            if n_iters is not None and it_idx >= n_iters:
                break
            batches.append(data)
        return batches

    @torch.no_grad()
    def evaluate(self, state: TrainState, graphs: List[Dict],
                 n_iters: Optional[int] = None):
        """Returns (avg_loss, avg_metric).  avg_loss weights each batch
        loss by its graph count (reference test(), :198-206); the metric
        is the sum-reduction prediction fn over |D|, or the evaluator
        (ROC-AUC) on the split's concatenated predictions."""
        if self.tcfg.evaluator not in (None, "rocauc"):
            raise ValueError(f"unknown evaluator {self.tcfg.evaluator!r}")
        model = state.model
        model.eval()
        total_loss = total_acc = 0.0
        total_n = 0
        y_true_all, y_pred_all = [], []
        for data in self._eval_batches(graphs, n_iters):
            data = self.to_device(data)
            y_hat = model(data)
            n = int(data.graph_mask.sum())
            total_loss += float(self.loss_fn(y_hat, data.y,
                                             data.graph_mask)) * n
            if self.pred_fn is not None:
                total_acc += float(self.pred_fn(y_hat, data.y,
                                                data.graph_mask))
            total_n += n
            if self.tcfg.evaluator is not None:
                mask = data.graph_mask.cpu().numpy()
                y_true_all.append(data.y.cpu().numpy()[mask])
                y_pred_all.append(y_hat.cpu().numpy()[mask])
        avg_loss = total_loss / max(total_n, 1)
        if self.tcfg.evaluator == "rocauc":
            return avg_loss, roc_auc_score(np.concatenate(y_true_all),
                                           np.concatenate(y_pred_all))
        return avg_loss, total_acc / max(total_n, 1)
