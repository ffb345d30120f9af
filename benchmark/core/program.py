"""The system under test, driven as its configuration's driver drives
it (``drivers/<driver>.py``: the program's data path, its trainer and
one epoch as its CLI runs them, the only place that knows the CLI).

Set-up drives the trainer from the seed through its first steps with
the window's own call (``train_epoch``, one batch a call) and reads
what the comparison needs: each step's loss, the first gradient from
Adam's moments, the batch-norm statistics after the first step, the
parameters and statistics after the steps, the dropout masks the steps
drew and an evaluation of the val split with what each of its batches
read back.  The same trainer and state then go into the window.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

ADAM_BETA1 = 0.9


def _buffers(model) -> Dict[str, torch.Tensor]:
    return {n: b.detach().float().cpu().clone()
            for n, b in model.named_buffers()}


def _keeping(fn, kept: List):
    """``fn`` (an evaluation's per-batch path), keeping what it returns:
    per batch (loss, graphs, metric sum, labels, predictions)."""
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        kept.extend(out)
        return out
    return call


class MaskRecorder(TorchFunctionMode):
    """Keeps every mask ``Tensor.bernoulli_`` draws (the dropout masks):
    ``eager`` those drawn outside a CUDA-graph capture, ``captured`` the
    capture's own buffers, which each replay refills."""

    def __init__(self):
        super().__init__()
        self.eager, self.captured = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") == "bernoulli_":
            capturing = (torch.cuda.is_available()
                         and torch.cuda.is_current_stream_capturing())
            (self.captured if capturing else self.eager).append(out)
        return out


class RunLog:
    """``fit``'s logger, in memory."""

    def __init__(self):
        self.records = []

    def log(self, rec, step=None):
        self.records.append(dict(rec, epoch=step))


class Program:
    """One cell's trainer and state, from set-up to the end of the
    window."""

    def __init__(self, driver, flags, splits, seed: int, device,
                 init_params, prepared=None):
        """``driver``: the configuration's driver module; ``prepared``:
        another Program's data path, reused."""
        t0 = time.perf_counter()
        self.driver = driver
        self.args, self.splits, self.cfg, self.dims = (
            prepared.args, prepared.splits, prepared.cfg, prepared.dims) \
            if prepared else driver.prepare(flags, splits, seed)
        self.prepare_s = time.perf_counter() - t0
        self.train = self.splits["train"]
        self.trainer = driver.trainer(self.args, self.cfg, self.train,
                                      device)
        self.tcfg = self.trainer.tcfg
        t1 = time.perf_counter()
        self.state = self.trainer.init_state(seed=seed)
        t2 = time.perf_counter()
        self._load(init_params(self.dims))
        self.timings = {"trainer": t1 - t0 - self.prepare_s,
                        "init_state": t2 - t1,
                        "load": time.perf_counter() - t2}

    def ids(self) -> List[np.ndarray]:
        """The encoded ids of every molecule, in split order."""
        return [g["identifiers"] for n in self.splits
                for g in self.splits[n]]

    def _load(self, params: Dict[str, torch.Tensor]) -> None:
        """The harness's initial parameters into the program's model, by
        name (the two sets of names and shapes must agree)."""
        model = dict(self.state.model.named_parameters())
        want = {n: tuple(p.shape) for n, p in params.items()}
        have = {n: tuple(p.shape) for n, p in model.items()}
        if want != have:
            diff = sorted(set(want.items()) ^ set(have.items()))
            raise RuntimeError(f"the program's parameters differ from the "
                               f"reference's: {diff[:6]}")
        with torch.no_grad():
            for n, p in model.items():
                p.copy_(params[n].to(p.device))

    def first_steps(self, rows: List[np.ndarray]) -> Dict:
        """A ``train_epoch`` call on each of ``rows`` (one batch of train
        rows each), then an evaluation of the val split: what the
        comparison reads (with the parameters and batch-norm statistics
        that evaluation used, and its batches' rows as ``evaluate``
        read them back: each batch's loss and graphs, and each graph's
        prediction where the split's metric needs them)."""
        t = self.trainer
        out = {"losses": [], "masks": []}
        model = self.state.model
        captured = []
        for k, idx in enumerate(rows):
            rec = MaskRecorder()
            with rec:
                self.state, loss = t.train_epoch(
                    self.state, [self.train[i] for i in idx])
            if k == 0:
                self.capture_s = t.epoch_stats.get("capture_s", 0.0)
            captured = rec.captured or captured
            drawn = rec.eager or captured
            out["masks"].append([m.detach().clone() for m in drawn])
            out["losses"].append(float(loss))
            if k == 0:
                out["stats1"] = _buffers(model)
                opt = self.state.optimizer
                # a step that made no moments shows a zero gradient
                out["grad1"] = {
                    n: (opt.state[p].get("exp_avg", torch.zeros_like(p))
                        / (1 - ADAM_BETA1)).float().cpu()
                    for n, p in self.state.model.named_parameters()}
        out["params"] = {n: p.detach().float().cpu().clone()
                         for n, p in model.named_parameters()}
        out["stats"] = _buffers(model)
        per_batch = []
        for name in ("_eval_runs", "_eval_steps"):
            setattr(t, name, _keeping(getattr(t, name), per_batch))
        try:
            out["eval"] = t.evaluate(self.state, self.splits["val"])
        finally:
            for name in ("_eval_runs", "_eval_steps"):
                delattr(t, name)
        out["eval_rows"] = {
            "loss": [b[0] for b in per_batch],
            "n": [b[1] for b in per_batch],
            "pred": (np.concatenate([np.ravel(b[4]) for b in per_batch])
                     if per_batch and per_batch[0][4] is not None
                     else None)}
        # the recorded buffers of the capture stay allocated to it
        self._masks_kept = captured
        return out

    def epoch(self, logger: RunLog) -> None:
        """One epoch as the driver's CLI runs it, its record logged."""
        self.state = self.driver.epoch(self.trainer, self.state,
                                       self.splits, logger)

    def slice_subsets(self, train_batches: int, eval_batches: int,
                      seed: int):
        """A train subset of ``train_batches`` batches (drawn from the
        seed) and the first ``eval_batches`` batches of the val split."""
        b = self.tcfg.batch_size
        rng = np.random.RandomState(seed % (2 ** 32))
        pick = rng.permutation(len(self.train))[:train_batches * b]
        return ([self.train[i] for i in np.sort(pick)],
                self.splits["val"][:eval_batches * b])

    def run_slice(self, train_sub, eval_sub) -> None:
        """The window's calls on the subsets: a train epoch of the train
        subset, an evaluation of the eval subset."""
        self.state, _loss = self.trainer.train_epoch(self.state, train_sub)
        self.trainer.evaluate(self.state, eval_sub)

    def close(self) -> None:
        """Drop the trainer, its graphs and the model."""
        self.trainer = self.state = self._masks_kept = None
