"""Parameter initializers matching the reference package's defaults
(flax ``Dense``: lecun-normal kernel, zero bias; ``nn.Embed`` as used by
``MultiEmbedding``: xavier-uniform), drawn from an explicit
``torch.Generator`` so a seed fixes the weights."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(t: torch.Tensor, std: float,
                   generator: Optional[torch.Generator]) -> None:
    """In-place N(0, std^2) truncated to [-2 std, 2 std] by inverse-CDF
    sampling."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0))


@torch.no_grad()
def init_parameters(model: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """(Re)initialize every parameter of ``model`` in module order.

    ``nn.Linear``: lecun-normal weight (fan-in = in_features), zero bias.
    ``nn.Embedding``: xavier-uniform table (zeros where the owner set
    ``zeros_init``).  Loose bias parameters (``*_bias``) and the ogb and
    gin layers' learned ``eps``: zeros.  A ``CentralEncoder``'s
    ``central`` row [1, d]: xavier-uniform.
    Batch-norm affine and running statistics: ones / zeros."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            _trunc_normal_(module.weight,
                           math.sqrt(1.0 / module.in_features) / _TRUNC_STD,
                           generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            if getattr(module, "zeros_init", False):
                module.weight.zero_()
            else:
                v, d = module.weight.shape
                lim = math.sqrt(6.0 / (v + d))
                module.weight.uniform_(-lim, lim, generator=generator)
        for name, p in module.named_parameters(recurse=False):
            if name.endswith("_bias") or name == "eps":
                p.zero_()
            elif name == "central":
                lim = math.sqrt(6.0 / sum(p.shape))
                p.uniform_(-lim, lim, generator=generator)
