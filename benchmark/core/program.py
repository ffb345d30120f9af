"""The system under test, driven as its CLI drives it.

Everything the benchmark takes from the program goes through here: the
port's data path (substructure counting and id encoding, as
``gsn_tpu_torch.cli.prepare`` runs them after a loader), its model
configuration and ``Trainer`` (``cli.trainer_config``), and
``Trainer.fit`` one epoch at a time.  Set-up drives the trainer from
the seed through its first steps with the window's own call
(``train_epoch``, one batch a call) and reads what the comparison
needs: each step's loss, the first gradient from Adam's moments, the
batch-norm statistics after the first step, the parameters and
statistics after the steps, the dropout masks the steps drew and an
evaluation of the val split with what each of its batches read back.
The same trainer and state then go into the window.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

ADAM_BETA1 = 0.9


def argv_of(flags: Dict[str, str], seed: int) -> List[str]:
    out = []
    for k, v in flags.items():
        out += [k, str(v)]
    return out + ["--seed", str(seed)]


def prepare(flags: Dict[str, str], splits: Dict[str, List[Dict]],
            seed: int):
    """(args, {split: graphs}, model config, num_classes): the CLI's
    ``prepare`` on graphs a loader returned (``cli.prepare`` minus the
    file read and the cache), then its splits."""
    from gsn_tpu_torch.cli import _model_config, build_parser
    from gsn_tpu_torch.data.encoding import encode
    from gsn_tpu_torch.data.pipeline import generate_dataset
    from gsn_tpu_torch.graphs.patterns import resolve_pattern_vocabulary

    args = vars(build_parser().parse_args(argv_of(flags, seed)))
    names = list(splits)
    graphs = [g for n in names for g in splits[n]]
    vocab = resolve_pattern_vocabulary(
        args["id_type"], args["k"], root_folder=args["root_folder"],
        custom_edge_list=args["custom_edge_list"])
    graphs, _sizes = generate_dataset(
        graphs, vocab, id_scope=args["id_scope"], induced=args["induced"],
        directed_orbits=args["directed_orbits"],
        num_processes=(args["num_processes"] if args["multiprocessing"]
                       else 1))
    num_classes = int(np.asarray(graphs[0]["y"]).size)
    in_features = graphs[0]["x"].shape[1] if graphs[0]["x"].ndim > 1 else 1
    ef = graphs[0]["edge_features"]
    in_edge_features = ef.shape[1] if ef.ndim > 1 else 1
    if args["dataset"] == "chemical" and args["dataset_name"] == "ZINC":
        d_in_node, d_in_edge = [28], [4]
    else:
        d_in_node, d_in_edge = [in_features], [in_edge_features]
    degree_encoding = (args["degree_encoding"] if args["degree_as_tag"]
                       else None)
    id_encoding = (args["id_encoding"] if args["id_encoding"] != "None"
                   else None)
    graphs, _e, d_id, _ed, d_degree = encode(graphs, id_encoding,
                                             degree_encoding)
    cfg = _model_config(args, num_classes, in_features, in_edge_features,
                        d_in_node, d_in_edge, d_id, d_degree)
    out, at = {}, 0
    for n in names:
        out[n] = graphs[at:at + len(splits[n])]
        at += len(splits[n])
    return args, out, cfg


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

    def __init__(self, flags, splits, seed: int, device, init_params,
                 prepared=None):
        """``prepared``: another Program's data path, reused."""
        from gsn_tpu_torch.cli import trainer_config
        from gsn_tpu_torch.train.loop import Trainer

        t0 = time.perf_counter()
        self.args, self.splits, self.cfg = (
            prepared.args, prepared.splits, prepared.cfg) if prepared \
            else prepare(flags, splits, seed)
        self.prepare_s = time.perf_counter() - t0
        self.train = self.splits["train"]
        self.tcfg = trainer_config(self.args)
        self.trainer = Trainer(self.cfg, self.tcfg, self.train,
                               device=device)
        t1 = time.perf_counter()
        self.state = self.trainer.init_state(seed=self.args["seed"])
        t2 = time.perf_counter()
        self._load(init_params(self.cfg.d_in_id))
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
        """One epoch of ``fit``: train, evaluate train, test and val,
        the scheduler's step."""
        t = self.trainer
        t.tcfg.num_epochs = self.state.epoch + 1
        self.state, _hist = t.fit(
            self.state, self.train, self.splits["test"],
            graphs_val=self.splits["val"], checkpoint_file=None,
            log_fn=None, logger=logger)

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
