"""The port's host metrics against ``gsn_tpu/train/metrics.py``: binary
F1 and MAE on random inputs (equal to the last bit: the same numpy
arithmetic) and on the edge cases of
``tests/test_train.py::test_f1_and_mae``; ROC-AUC and AP beside them."""

import numpy as np
import pytest

from gsn_tpu.train import metrics as ref
from gsn_tpu_torch.train import metrics


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f1_and_mae_match_reference(seed):
    rng = np.random.RandomState(seed)
    n = 50 + 37 * seed
    yt = rng.randint(0, 2, n)
    yp = rng.randint(0, 2, n)
    assert metrics.binary_f1_score(yt, yp) == ref.binary_f1_score(yt, yp)
    a, b = rng.randn(n).astype(np.float32), rng.randn(n, 1)
    assert metrics.mean_absolute_error(a, b) == ref.mean_absolute_error(a, b)
    # the evaluator metrics agree on the same inputs too
    score = rng.rand(n)
    assert metrics.roc_auc_score(yt, score) == ref.roc_auc_score(yt, score)
    assert (metrics.average_precision_score(yt, score)
            == ref.average_precision_score(yt, score))


def test_f1_and_mae_edge_cases():
    yt = np.array([1, 1, 0, 0, 1])
    yp = np.array([1, 0, 0, 1, 1])
    # tp=2 fp=1 fn=1 -> f1 = 4/(4+2) = 2/3
    assert abs(metrics.binary_f1_score(yt, yp) - 2 / 3) < 1e-9
    assert metrics.binary_f1_score(np.zeros(3), np.zeros(3)) == 0.0
    assert metrics.binary_f1_score(yt, yp) == ref.binary_f1_score(yt, yp)
    assert abs(metrics.mean_absolute_error([1.0, 2.0], [1.5, 1.0])
               - 0.75) < 1e-9
    # column and row vectors ravel alike
    assert metrics.mean_absolute_error(np.ones((3, 1)),
                                       np.zeros(3)) == 1.0
