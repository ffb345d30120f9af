"""Checkpoint / resume (counterpart of ``gsn_tpu/train/checkpoint.py``,
reference train_test_funcs.py:37-46,161-166).

A checkpoint is one ``torch.save`` file holding the model's
``state_dict`` (parameters and BN running statistics), the optimizer's,
the scheduler state, the dropout generators' states, the host shuffle
stream's state and the epoch.  It is written to ``<path>.tmp`` and then
moved over ``path``, so a reader never sees half a file.

``epoch`` is the index of the last finished epoch, as in the reference,
and ``load_checkpoint`` returns ``epoch + 1``, the epoch to resume at.
(The reference package stores its state's epoch count, one more than
that index, so its resume starts one epoch later.)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch


def _rng_state(rng: np.random.RandomState):
    """``rng``'s state in plain Python types (``weights_only`` loads)."""
    name, keys, pos, has_gauss, cached = rng.get_state()
    return [name, keys.tolist(), int(pos), int(has_gauss), float(cached)]


def save_checkpoint(path: str, state, scheduler,
                    rng: Optional[np.random.RandomState] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "epoch": int(state.epoch) - 1,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": scheduler.state_dict() if scheduler is not None else None,
        "dropout_gen": state.dropout_gen.get_state(),
        "node_gen": (state.node_gen.get_state()
                     if state.node_gen is not None else None),
        "host_rng": _rng_state(rng) if rng is not None else None,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state, scheduler=None,
                    rng: Optional[np.random.RandomState] = None):
    """Restore into ``state`` (its model and optimizer in place; shapes
    must match), ``scheduler`` and ``rng`` where given.

    Returns (state, start_epoch)."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.dropout_gen.set_state(payload["dropout_gen"].cpu())
    if state.node_gen is not None and payload.get("node_gen") is not None:
        state.node_gen.set_state(payload["node_gen"].cpu())
    if scheduler is not None and payload["scheduler"] is not None:
        scheduler.load_state_dict(payload["scheduler"])
    if rng is not None and payload["host_rng"] is not None:
        name, keys, pos, has_gauss, cached = payload["host_rng"]
        rng.set_state((name, np.asarray(keys, np.uint32), pos, has_gauss,
                       cached))
    start = payload["epoch"] + 1
    return dataclasses.replace(state, epoch=start), start
