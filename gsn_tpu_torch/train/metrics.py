"""Losses and sum-reduction prediction functions (counterpart of
``gsn_tpu/train/metrics.py``).

All take a graph mask so padded graph slots contribute nothing: losses
are means over real graphs (training), prediction fns are sums (eval
accumulation), as in the reference (``utils.py:163-192``).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def _mask_like(pred, mask):
    m = mask.reshape((-1,) + (1,) * (pred.dim() - 1)).to(torch.float32)
    return m.expand_as(pred)


def cross_entropy_loss(logits, y, mask):
    nll = -F.log_softmax(logits, dim=-1).gather(
        -1, y.long()[:, None])[:, 0]
    m = mask.to(torch.float32)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def bce_with_logits_loss(logits, y, mask):
    """BCEWithLogitsLoss with NaN-label masking (OGB unlabeled targets,
    reference train_test_funcs.py:94-101)."""
    y = y.reshape(logits.shape).to(torch.float32)
    labeled = torch.isfinite(y)
    m = mask.to(torch.float32)
    m = (m[:, None] if logits.dim() > 1 else m) * labeled.to(torch.float32)
    y_safe = torch.where(labeled, y, torch.zeros_like(y))
    per = (torch.clamp(logits, min=0) - logits * y_safe
           + torch.log1p(torch.exp(-logits.abs())))
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def mse_loss(pred, y, mask):
    y = y.reshape(pred.shape).to(torch.float32)
    m = _mask_like(pred, mask)
    return ((pred - y).square() * m).sum() / torch.clamp(m.sum(), min=1.0)


def l1_loss(pred, y, mask):
    y = y.reshape(pred.shape).to(torch.float32)
    m = _mask_like(pred, mask)
    return ((pred - y).abs() * m).sum() / torch.clamp(m.sum(), min=1.0)


LOSSES = {
    "CrossEntropyLoss": cross_entropy_loss,
    "BCEWithLogitsLoss": bce_with_logits_loss,
    "MSELoss": mse_loss,
    "L1Loss": l1_loss,
}


def multi_class_accuracy_sum(logits, y, mask):
    pred = logits.argmax(-1)
    return ((pred == y.to(pred.dtype)) & mask).to(torch.float32).sum()


def mse_sum(pred, y, mask):
    y = y.reshape(pred.shape).to(torch.float32)
    return ((pred - y).square() * _mask_like(pred, mask)).sum()


def l1_sum(pred, y, mask):
    y = y.reshape(pred.shape).to(torch.float32)
    return ((pred - y).abs() * _mask_like(pred, mask)).sum()


PREDICTION_FNS = {
    "multi_class_accuracy": multi_class_accuracy_sum,
    "MSELoss": mse_sum,
    "L1Loss": l1_sum,
    "None": None,
}
