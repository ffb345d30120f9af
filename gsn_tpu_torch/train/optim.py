"""Optimization setup (counterpart of ``gsn_tpu/train/optim.py``).

Reference ``train_test_funcs.py:18-35`` semantics:
- torch Adam with ``weight_decay`` = L2-regularized Adam (decay added to
  the gradient before the moment updates; eps outside the square root),
  which is what the reference package builds from optax
  (``add_decayed_weights`` then ``scale_by_adam(eps=1e-8)``);
- StepLR steps every epoch: ``lr = lr0 * gamma^(epoch // decay_steps)``.

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
                   decay_rate: float = 0.5):
    if name == "StepLR":
        return StepLR(lr, decay_steps, decay_rate)
    if name in (None, "None"):
        return ConstantLR(lr)
    raise NotImplementedError(f"scheduler {name!r} is not ported yet")
