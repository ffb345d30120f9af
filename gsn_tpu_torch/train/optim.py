"""Optimization setup (counterpart of ``gsn_tpu/train/optim.py``).

Reference ``train_test_funcs.py:18-35`` semantics:
- torch Adam with ``weight_decay`` = L2-regularized Adam (decay added to
  the gradient before the moment updates; eps outside the square root),
  which is what the reference package builds from optax
  (``add_decayed_weights`` then ``scale_by_adam(eps=1e-8)``);
- StepLR steps every epoch: ``lr = lr0 * gamma^(epoch // decay_steps)``;
- ReduceLROnPlateau (min mode) multiplies lr by ``decay_rate`` after
  ``patience`` non-improving evals.

The trainer sets the learning rate from the scheduler (``set_lr``), so
the scheduler objects are plain Python state.  On the card Adam is built
``capturable`` with its rate a 0-dim device tensor, which ``set_lr``
fills: a captured CUDA graph of the step reads the rate from that
tensor on every replay (as the reference hands its scanned epochs the
rate as an array, ``gsn_tpu/train/loop.py::_with_lr``), and the
per-step path runs the same Adam, so both do the same arithmetic.  The
CPU keeps a float rate and ``capturable=False``, which PyTorch requires
there.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.0,
                   device=None) -> torch.optim.Adam:
    """torch.optim.Adam(lr, weight_decay): L2-regularized Adam; on a
    CUDA ``device`` capturable, its rate a device tensor."""
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        return torch.optim.Adam(
            params, lr=torch.tensor(lr, dtype=torch.float32, device=device),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
            capturable=True)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every param group's rate to ``lr``: filled into a capturable
    optimizer's device tensor (made anew when a loaded state dict left a
    float or another device's tensor there, and ``capturable`` set
    again), else stored as the float."""
    for group in optimizer.param_groups:
        dev = group["params"][0].device
        if dev.type != "cuda":
            group["lr"] = lr
            continue
        rate = group["lr"]
        if not (torch.is_tensor(rate) and rate.device == dev):
            group["lr"] = torch.empty((), dtype=torch.float32, device=dev)
            group["capturable"] = True
        group["lr"].fill_(lr)


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
