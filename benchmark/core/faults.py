"""Faults planted under the timed path, each of which the check has to
catch (the cells run on one chip, so no exchange between chips can be
left out):

- ``unchanged``: the step returns its state unchanged (Adam's step does
  nothing);
- ``half_batch``: half of each batch's graphs left out of the loss, the
  mean taken over the rest;
- ``answer``: an answer altered where it is produced (each evaluated
  batch's first prediction 0.1 higher);
- ``dropout``: the dropout stage wrong (every rate 0.3 higher), which
  only the masks' own check can see where the reference follows the
  program's masks.
"""

from __future__ import annotations

import torch


def unchanged(prog) -> None:
    prog.state.optimizer.step = lambda *a, **k: None


def half_batch(prog) -> None:
    t = prog.trainer
    loss_fn = t.loss_fn

    def first_half(y_hat, y, mask):
        m = mask.to(torch.int32)
        keep = mask & (torch.cumsum(m, 0) <= (m.sum() + 1) // 2)
        return loss_fn(y_hat, y, keep)

    t.loss_fn = first_half


def answer(prog) -> None:
    model = prog.state.model
    forward = model.forward

    def altered(*args, **kwargs):
        out = forward(*args, **kwargs)
        if model.training:
            return out
        out = out.clone()
        out[0] = out[0] + 0.1
        return out

    model.forward = altered


def dropout(prog) -> None:
    cfg = prog.state.model.cfg
    cfg.dropout_features = [r + 0.3 for r in cfg.dropout_features]


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "answer": answer, "dropout": dropout}
