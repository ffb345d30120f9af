"""Masked batch normalization (counterpart of ``gsn_tpu/ops/norm.py``).

Padded batches must compute *masked* statistics to keep the reference's
unpadded BatchNorm1d semantics:
- eps 1e-5, momentum 0.1 (new = (1-m)*old + m*batch);
- masked statistics with the row count clamped to at least 1;
- normalization uses the biased variance, the running-var update the
  *unbiased* batch variance (torch BatchNorm semantics);
- running statistics update only in training mode;
- a bf16 input (the bf16 compute dtype) gets f32 statistics and f32
  arithmetic, and the output is rounded back to bf16;
- ``axis_name`` (data or edge parallelism): the masked moments
  ``(n, Σx, Σx²)`` are summed over the ranks of that mesh axis before
  the mean and variance (``gsn_tpu/ops/norm.py:84-86``), on both the
  ``x`` path and the fused-BN ``moments`` path, so every rank normalizes
  with the statistics of the whole batch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gsn_tpu_torch.parallel.collectives import all_reduce


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over rows with an optional row-validity mask."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, axis_name: Optional[str] = None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: Optional[torch.Tensor],
                mask: Optional[torch.Tensor] = None,
                moments: Optional[tuple] = None):
        """Normalize ``x`` — or, when ``x is None`` and ``moments=(n,
        sum_x, sum_x2)`` is given, run only the statistics machinery
        (same running-stat updates) and return ``(mean, var, weight,
        bias)`` so a fused kernel can fold the normalization into its
        affine inputs."""
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if moments is not None:
                n, sum_x, sum_x2 = moments
                n = torch.as_tensor(n, dtype=torch.float32,
                                    device=sum_x.device)
            elif mask is None:
                xf = x.float()
                n = torch.tensor(float(x.shape[0]), device=x.device)
                sum_x = xf.sum(0)
                sum_x2 = xf.square().sum(0)
            else:
                xf = x.float()
                m = mask.to(torch.float32)[:, None]
                n = m.sum()
                sum_x = (xf * m).sum(0)
                sum_x2 = (xf.square() * m).sum(0)
            if self.axis_name is not None:
                # one collective for the three moments
                d = sum_x.shape[0]
                both = all_reduce(torch.cat([n.reshape(1), sum_x, sum_x2]),
                                  self.axis_name)
                n, sum_x, sum_x2 = both[0], both[1:d + 1], both[d + 1:]
            n = torch.clamp(n, min=1.0)
            mean = sum_x / n
            var = torch.clamp(sum_x2 / n - mean.square(), min=0.0)
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        if x is None:
            return mean, var, self.weight, self.bias
        if x.dtype != torch.float32:
            # the reference's folded per-channel affine in f32, rounded
            # once to the input dtype
            s = self.weight * torch.reciprocal(torch.sqrt(var + self.eps))
            return (x.float() * s + (self.bias - mean * s)).to(x.dtype)
        y = (x - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        return y * self.weight + self.bias
