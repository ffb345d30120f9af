"""Dataset splits: stratified 10-fold CV + precomputed index files (a
copy of ``gsn_tpu/data/splits.py``).

Replaces sklearn's StratifiedKFold (reference utils_data_prep.py:215-237)
with a self-contained implementation matching its shuffled semantics, and
reads the reference's bundled ``10fold_idx/{train,test,val}_idx-*.txt``
files (utils_data_prep.py:239-259).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def stratified_kfold_indices(labels: np.ndarray, n_splits: int = 10,
                             seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled stratified k-fold: per-class shuffle, round-robin fold
    assignment balanced per class."""
    rng = np.random.RandomState(seed)
    labels = np.asarray(labels).ravel()
    folds = [[] for _ in range(n_splits)]
    for cls in np.unique(labels):
        idx = np.where(labels == cls)[0]
        rng.shuffle(idx)
        for i, j in enumerate(idx):
            folds[i % n_splits].append(j)
    out = []
    all_idx = np.arange(len(labels))
    for f in range(n_splits):
        test = np.sort(np.array(folds[f], dtype=np.int64))
        train = np.setdiff1d(all_idx, test)
        out.append((train, test))
    return out


def separate_data(graphs: List[dict], seed: int, fold_idx: int,
                  n_splits: int = 10):
    """Stratified CV split by graph label (reference
    utils_data_prep.py:215-237)."""
    assert 0 <= fold_idx < n_splits
    labels = np.array([int(g["y"]) for g in graphs])
    train_idx, test_idx = stratified_kfold_indices(
        labels, n_splits, seed)[fold_idx]
    return ([graphs[i] for i in train_idx], [graphs[i] for i in test_idx])


def separate_data_given_split(graphs: List[dict], path: str, fold_idx: int):
    """Bundled 10fold_idx text splits; fold -1 is the model-selection
    split (reference utils_data_prep.py:239-259)."""
    assert -1 <= fold_idx < 10
    base = os.path.join(path, "10fold_idx")
    train_idx = np.loadtxt(
        os.path.join(base, f"train_idx-{fold_idx + 1}.txt"), dtype=int)
    test_idx = np.loadtxt(
        os.path.join(base, f"test_idx-{fold_idx + 1}.txt"), dtype=int)
    val_file = os.path.join(base, f"val_idx-{fold_idx + 1}.txt")
    val: Optional[List[dict]] = None
    if os.path.exists(val_file):
        val_idx = np.loadtxt(val_file, dtype=int)
        val = [graphs[i] for i in np.atleast_1d(val_idx)]
    return ([graphs[i] for i in np.atleast_1d(train_idx)],
            [graphs[i] for i in np.atleast_1d(test_idx)], val)
