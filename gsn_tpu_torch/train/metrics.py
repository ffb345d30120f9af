"""Losses and sum-reduction prediction functions (counterpart of
``gsn_tpu/train/metrics.py``).

All take a graph mask so padded graph slots contribute nothing: losses
are means over real graphs (training), prediction fns are sums (eval
accumulation), as in the reference (``utils.py:163-192``).  The OGB
evaluator metrics (ROC-AUC, AP) run on the host over a split's
concatenated predictions, and so do binary F1 and MAE on host arrays.
"""

from __future__ import annotations

import numpy as np
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


# ---------------------------------------------------------------------------
# ROC-AUC / AP (host-side numpy; replaces ogb.Evaluator)
# ---------------------------------------------------------------------------

def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Rank-based AUC (ties averaged), averaged over labeled tasks —
    matches ogb's rocauc eval for molhiv (single task)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    y_true = y_true.reshape(len(y_true), -1)
    y_score = y_score.reshape(len(y_score), -1)
    aucs = []
    for t in range(y_true.shape[1]):
        yt, ys = y_true[:, t], y_score[:, t]
        labeled = np.isfinite(yt)
        yt, ys = yt[labeled], ys[labeled]
        pos, neg = (yt == 1).sum(), (yt == 0).sum()
        if pos == 0 or neg == 0:
            continue
        order = np.argsort(ys, kind="mergesort")
        ranks = np.empty(len(ys), dtype=np.float64)
        ranks[order] = np.arange(1, len(ys) + 1)
        # average tied ranks
        sorted_scores = ys[order]
        i = 0
        while i < len(ys):
            j = i
            while j + 1 < len(ys) and sorted_scores[j + 1] == sorted_scores[i]:
                j += 1
            if j > i:
                avg = (i + j) / 2.0 + 1.0
                ranks[order[i:j + 1]] = avg
            i = j + 1
        auc = (ranks[yt == 1].sum() - pos * (pos + 1) / 2.0) / (pos * neg)
        aucs.append(auc)
    if not aucs:
        raise ValueError("no task with both positive and negative labels")
    return float(np.mean(aucs))


def average_precision_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP, averaged over labeled tasks (ogb 'ap' metric, molpcba)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    y_true = y_true.reshape(len(y_true), -1)
    y_score = y_score.reshape(len(y_score), -1)
    aps = []
    for t in range(y_true.shape[1]):
        yt, ys = y_true[:, t], y_score[:, t]
        labeled = np.isfinite(yt)
        yt, ys = yt[labeled], ys[labeled]
        if (yt == 1).sum() == 0 or (yt == 0).sum() == 0:
            continue
        order = np.argsort(-ys, kind="mergesort")
        yt = yt[order]
        tp = np.cumsum(yt == 1)
        precision = tp / np.arange(1, len(yt) + 1)
        aps.append((precision * (yt == 1)).sum() / (yt == 1).sum())
    if not aps:
        raise ValueError("no task with both positive and negative labels")
    return float(np.mean(aps))


def binary_f1_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Binary F1 over hard predictions (0 when there is no positive in
    either; reference directional_gsn/train/metrics.py keeps per-class F1
    among its benchmark metrics)."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    tp = float(((y_pred == 1) & (y_true == 1)).sum())
    fp = float(((y_pred == 1) & (y_true == 0)).sum())
    fn = float(((y_pred == 0) & (y_true == 1)).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def mean_absolute_error(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """MAE (reference directional_gsn/train/metrics.py MAE)."""
    return float(np.mean(np.abs(np.asarray(y_true).ravel()
                                - np.asarray(y_pred).ravel())))
