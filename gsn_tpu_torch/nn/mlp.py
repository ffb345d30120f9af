"""MLP block and activation registry (counterpart of
``gsn_tpu/nn/mlp.py``, reference ``models_misc.py``): Linear stacks with
optional masked BatchNorm between hidden layers (never after the last)
and a chosen activation."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from gsn_tpu_torch.ops.norm import MaskedBatchNorm


def choose_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "tanh":
        return torch.tanh
    if name == "identity":
        return lambda x: x
    raise NotImplementedError(f"activation {name!r}")


class MLP(nn.Module):
    """Linear stack: hidden widths ``d_hidden`` then ``d_out`` (the last
    layer has no activation/BN).  Layers are named ``dense_i`` and
    ``bn_i`` as in the reference package."""

    def __init__(self, d_in: int, d_out: int, d_hidden: Sequence[int] = (),
                 activation: str = "elu", batch_norm: bool = False):
        super().__init__()
        self.num_hidden = len(d_hidden)
        self.batch_norm = batch_norm
        self.act = choose_activation(activation)
        widths = [d_in, *d_hidden]
        for i, d in enumerate(d_hidden):
            setattr(self, f"dense_{i}", nn.Linear(widths[i], d))
            if batch_norm:
                setattr(self, f"bn_{i}", MaskedBatchNorm(d))
        setattr(self, f"dense_{self.num_hidden}",
                nn.Linear(widths[-1], d_out))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = getattr(self, f"dense_{i}")(x)
            if self.batch_norm:
                x = getattr(self, f"bn_{i}")(x, mask)
            x = self.act(x)
        return getattr(self, f"dense_{self.num_hidden}")(x)
