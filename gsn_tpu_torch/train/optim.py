"""Optimization setup (counterpart of ``gsn_tpu/train/optim.py``).

Reference ``train_test_funcs.py:18-35`` semantics:
- torch Adam with ``weight_decay`` = L2-regularized Adam (decay added to
  the gradient before the moment updates; eps outside the square root),
  which is what the reference package builds from optax
  (``add_decayed_weights`` then ``scale_by_adam(eps=1e-8)``);
- StepLR steps every epoch: ``lr = lr0 * gamma^(epoch // decay_steps)``;
- ReduceLROnPlateau (min mode) multiplies lr by ``decay_rate`` after
  ``patience`` non-improving evals.

The trainer sets each step's learning rate from the scheduler, so the
scheduler objects are plain Python state.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """torch.optim.Adam(lr, weight_decay): L2-regularized Adam."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


@dataclasses.dataclass
class StepLR:
    base_lr: float
    decay_steps: int
    decay_rate: float
    epoch: int = 0

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        return self.lr

    @property
    def lr(self) -> float:
        return self.base_lr * (self.decay_rate ** (self.epoch
                                                   // self.decay_steps))

    def state_dict(self):
        return {"epoch": self.epoch}

    def load_state_dict(self, s):
        self.epoch = s["epoch"]


@dataclasses.dataclass
class ReduceLROnPlateau:
    base_lr: float
    decay_rate: float
    patience: int
    mode: str = "min"
    current_lr: float = None
    best: float = None
    num_bad: int = 0

    def __post_init__(self):
        if self.current_lr is None:
            self.current_lr = self.base_lr

    def step(self, metric: float) -> float:
        better = (self.best is None
                  or (metric < self.best if self.mode == "min"
                      else metric > self.best))
        if better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current_lr *= self.decay_rate
                self.num_bad = 0
        return self.lr

    @property
    def lr(self) -> float:
        return self.current_lr

    def state_dict(self):
        return {"current_lr": self.current_lr, "best": self.best,
                "num_bad": self.num_bad}

    def load_state_dict(self, s):
        self.current_lr, self.best = s["current_lr"], s["best"]
        self.num_bad = s["num_bad"]


@dataclasses.dataclass
class ConstantLR:
    base_lr: float

    def step(self, metric: Optional[float] = None) -> float:
        return self.base_lr

    @property
    def lr(self) -> float:
        return self.base_lr

    def state_dict(self):
        return {}

    def load_state_dict(self, s):
        pass


def make_scheduler(name: str, lr: float, decay_steps: int = 50,
                   decay_rate: float = 0.5, patience: int = 20,
                   mode: str = "min"):
    if name == "StepLR":
        return StepLR(lr, decay_steps, decay_rate)
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(lr, decay_rate, patience, mode)
    if name in (None, "None"):
        return ConstantLR(lr)
    raise NotImplementedError(f"scheduler {name!r}")
