"""Training / evaluation engine (counterpart of
``gsn_tpu/train/loop.py``, reference ``train_test_funcs.py``): Adam
steps over padded batches, StepLR/Plateau scheduling, whole epochs with
the ``num_iters`` wrap-around, periodic evaluation (the ``rocauc``
evaluator included) with checkpoints, and the ``min_lr`` stop.

The host random stream is the reference's: one
``np.random.RandomState(seed)`` shuffles each epoch's order and then
gives one draw per iteration (the reference's dropout key), so epoch
orders match it.  Dropout masks come from the state's ``torch.Generator``.

The trainer runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit device it raises rather
than fall back.  On the card the hand-written kernels run; on the CPU
their plain PyTorch versions do.

``scan_epochs`` (the default, as in the reference) runs an epoch as the
reference's one-dispatch epochs do (``gsn_tpu/train/loop.py:182-350``):
its batches fall into runs of one shape signature, a run's distinct
batches go to the device once, and each step of a run is one replay of
a CUDA graph of the whole step, captured for its (state, signature)
at the start of the first run that needs it (``train/graphs.py``).
The losses of a run stay on the device and are read once a run; an
evaluation reads its per-batch numbers once a split.  A capture that
fails raises.  On the CPU the same runs drive the eager step.
``scan_epochs=False`` issues every step's launches from Python and
reads each loss back, as before.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import statistics
import time
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gsn_tpu_torch.graphs.batching import (epoch_caps, infer_y_spec,
                                           iterate_batches,
                                           tight_epoch_caps)
from gsn_tpu_torch.graphs.container import GraphBatch
from gsn_tpu_torch.nn.init import init_parameters
from gsn_tpu_torch.nn.models import DropoutStreams, build_model
from .checkpoint import save_checkpoint
from .graphs import StepGraph, batch_sig, runs, state_key, unique_slots
from .metrics import LOSSES, PREDICTION_FNS, roc_auc_score
from .optim import (ReduceLROnPlateau, StepLR, make_optimizer,
                    make_scheduler, set_lr)


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA card; raise when there is none
    (CPU runs must ask for the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


def full_f32_matmuls() -> None:
    """f32 products in full f32 on the card (no TF32), and bf16 products
    (the bf16 compute dtype) accumulated in f32 rather than reduced in
    bf16, as the TPU's matrix unit does: the port's tolerances against
    the reference assume both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    dropout_gen: torch.Generator   # dropout masks, on the model's device
    epoch: int = 0
    # an edge-partitioned rank's own stream for node rows (dropout_gen is
    # then the stream all ranks share); None off that path
    node_gen: Optional[torch.Generator] = None

    @property
    def generators(self):
        """What the model's ``forward`` takes for its dropout masks."""
        if self.node_gen is None:
            return self.dropout_gen
        return DropoutStreams(self.dropout_gen, self.node_gen)


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 0.01
    regularization: float = 0.0           # Adam weight_decay
    scheduler: str = "StepLR"
    decay_steps: int = 50
    decay_rate: float = 0.5
    patience: int = 20
    min_lr: float = 0.0
    batch_size: int = 16
    num_epochs: int = 300
    num_iters: Optional[int] = None       # partial epochs (wrap-around)
    num_iters_test: Optional[int] = None
    eval_frequency: int = 1
    loss_fn: str = "CrossEntropyLoss"
    prediction_fn: str = "multi_class_accuracy"
    evaluator: Optional[str] = None       # None | "rocauc"
    seed: int = 0
    shuffle: bool = True
    caps_mode: str = "worst"   # 'worst' = one shape for the whole run;
    #                            'tight' = caps of each epoch's own order
    # the reference's kernel layout: accepted for its configurations,
    # with no effect here (on the card the kernels always run)
    use_mxu_segment_sum: object = False
    # one-dispatch epochs: each run of same-shape batches replays a CUDA
    # graph of the step (module docstring)
    scan_epochs: bool = True


class Trainer:
    """Owns the model config, loss, scheduler and batching policy; the
    model and optimizer live in the ``TrainState`` from ``init_state``.

    ``model`` (as in the reference trainer) is a module to train in
    place of ``build_model(model_cfg)``, e.g. ``DGNNet(cfg)``; each
    ``init_state`` trains a copy of it with fresh weights."""

    # captured steps kept at once (a 'tight' caps_mode epoch is a
    # signature of its own), oldest dropped first
    MAX_GRAPHS = 8

    def __init__(self, model_cfg, tcfg: TrainerConfig,
                 graphs_train: List[Dict], device=None,
                 model: Optional[torch.nn.Module] = None):
        if tcfg.caps_mode not in ("worst", "tight"):
            raise ValueError(f"unknown caps_mode {tcfg.caps_mode!r}")
        self.device = resolve_device(device)
        full_f32_matmuls()
        self.model_cfg = (model_cfg.finalize()
                          if hasattr(model_cfg, "finalize") else model_cfg)
        self.model = model
        self.tcfg = tcfg
        self.loss_fn = LOSSES[tcfg.loss_fn]
        self.pred_fn = PREDICTION_FNS.get(tcfg.prediction_fn)
        self.scheduler = make_scheduler(
            tcfg.scheduler, tcfg.lr, tcfg.decay_steps, tcfg.decay_rate,
            tcfg.patience)
        # 'worst': one shape for every batch, the worst-case caps of the
        # train set; 'tight': each epoch's own caps (None here)
        self.caps = (epoch_caps(graphs_train, tcfg.batch_size)
                     if tcfg.caps_mode == "worst" else None)
        self.y_shape, self.y_dtype = infer_y_spec(graphs_train)
        self.flow = getattr(self.model_cfg, "flow", "source_to_target")
        self.rng = np.random.RandomState(tcfg.seed)
        self._eval_plans: Dict = {}
        # (kind, signature, state_key) -> StepGraph of the epoch executor
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()
        self._finalizers: Dict[int, weakref.finalize] = {}
        # the shards whose rows an evaluator pack holds (_eval_pack)
        self._pack_ranks = 1
        # the last train_epoch's host, step and capture times (seconds)
        self.epoch_stats: Dict[str, float] = {}

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh weights drawn from ``torch.Generator`` seeded with
        ``seed``, on the trainer's device, with a new optimizer; the
        dropout masks come from a generator on that device seeded with
        ``seed + 1`` (the reference's dropout key)."""
        gen = torch.Generator().manual_seed(seed)
        if self.model is None:
            model = build_model(self.model_cfg, gen)
        else:
            model = copy.deepcopy(self.model)
            init_parameters(model, gen)
        model = model.to(self.device)
        opt = make_optimizer(model.parameters(), self.tcfg.lr,
                             self.tcfg.regularization, self.device)
        dropout_gen = torch.Generator(device=self.device)
        dropout_gen.manual_seed(seed + 1)
        return TrainState(model=model, optimizer=opt,
                          dropout_gen=dropout_gen)

    def to_device(self, data: GraphBatch) -> GraphBatch:
        """A host-built (numpy) batch moved to the trainer's device."""
        if isinstance(data.x, np.ndarray):
            return data.to(self.device)
        return data

    def train_step(self, state: TrainState, data: GraphBatch,
                   lr: Optional[float] = None):
        """One Adam step on ``data``; returns (state, detached loss).
        ``lr`` defaults to the scheduler's current rate."""
        data = self.to_device(data)
        set_lr(state.optimizer, self.scheduler.lr if lr is None else lr)
        return state, self._train_loss(state, data)

    def _train_loss(self, state: TrainState, data: GraphBatch
                    ) -> torch.Tensor:
        """The step at the optimizer's current rate: what a train graph
        captures (it reads the rate from the optimizer's tensor)."""
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = self._step_loss(model(data, state.generators), data)
        self._backward(loss, model)
        opt.step()
        return loss.detach()

    def _step_loss(self, y_hat, data: GraphBatch) -> torch.Tensor:
        """The batch's loss (the parallel trainer's is global)."""
        return self.loss_fn(y_hat, data.y, data.graph_mask)

    def _backward(self, loss: torch.Tensor, model) -> None:
        """Fill the parameters' gradients (the parallel trainer also sums
        them over the ranks)."""
        loss.backward()

    def _eval_sums(self, y_hat, data: GraphBatch):
        """f32 (graphs, metric sum) of one eval batch on the device
        (global totals under the parallel trainer)."""
        acc = (self.pred_fn(y_hat, data.y, data.graph_mask)
               if self.pred_fn is not None else y_hat.new_zeros(()))
        return (data.graph_mask.sum().to(torch.float32),
                acc.to(torch.float32))

    def _eval_pack(self, y_hat, data: GraphBatch):
        """(y_hat, y, graph_mask) for evaluator metrics on the whole
        split (every rank's rows under data parallelism: the rows of
        ``_pack_ranks`` shards)."""
        return y_hat, data.y, data.graph_mask

    def _check_runs(self, sigs) -> None:
        """Before an epoch's or an evaluation's first run: nothing on one
        device (the parallel trainer checks that its ranks agree)."""

    def _train_batches(self, graphs: List[Dict]) -> List[GraphBatch]:
        """One epoch's (shuffled) host batches."""
        return list(iterate_batches(
            graphs, self.tcfg.batch_size, shuffle=self.tcfg.shuffle,
            rng=self.rng, caps=self.caps, y_shape=self.y_shape,
            y_dtype=self.y_dtype, flow=self.flow))

    def train_epoch(self, state: TrainState, graphs: List[Dict]):
        """One epoch of ``num_iters`` steps (default: every batch once;
        more wrap around to the first batch).  Returns (state, mean
        loss) and leaves in ``epoch_stats`` the epoch's seconds, steps,
        host batching and copy seconds, median step (a replay's device
        time under ``scan_epochs`` on the card, else the host's) and
        capture seconds (warm-up and capture; 0 once cached)."""
        t_start = t0 = time.perf_counter()
        batches = self._train_batches(graphs)
        build_s = time.perf_counter() - t0
        n_iters = self.tcfg.num_iters or len(batches)
        seq = []
        k = 0
        for _ in range(n_iters):
            if k >= len(batches):
                k = 0
            seq.append(batches[k])
            k += 1
            # the reference's per-iteration dropout key: drawn so that
            # later epochs' shuffles stay in step with its stream
            self.rng.randint(0, 2**31 - 1)
        run = self._train_runs if self.tcfg.scan_epochs else self._train_steps
        losses, copy_s, step_s, capture_s = run(state, seq)
        self.epoch_stats = dict(
            epoch_s=time.perf_counter() - t_start, steps=len(seq),
            host_batch_s=build_s + copy_s,
            step_median_s=statistics.median(step_s) if step_s else 0.0,
            capture_s=capture_s)
        state = dataclasses.replace(state, epoch=state.epoch + 1)
        return state, float(np.mean(losses)) if losses else 0.0

    def _train_steps(self, state: TrainState, seq: List[GraphBatch]):
        """Every step issued from Python, each loss read back: (losses,
        copy seconds, each step's host seconds, 0)."""
        losses, copy_s, step_s = [], 0.0, []
        for data in seq:
            t0 = time.perf_counter()
            data = self.to_device(data)
            t1 = time.perf_counter()
            state, loss = self.train_step(state, data)
            losses.append(float(loss))   # waits for the step
            copy_s += t1 - t0
            step_s.append(time.perf_counter() - t1)
        return losses, copy_s, step_s, 0.0

    def _train_runs(self, state: TrainState, seq: List[GraphBatch]):
        """The runs of same-shape batches, each step a replay of the
        state's train graph for the run's signature (captured first
        where there is none): (losses, copy seconds, step seconds, the
        seconds of warm-up and capture)."""
        cuda = self.device.type == "cuda"
        losses, step_s = [], []
        copy_s = capture_s = 0.0
        sigs = [batch_sig(b) for b in seq]
        self._check_runs(sigs)
        for i, j in runs(sigs):
            t0 = time.perf_counter()
            uniq, idxs = unique_slots(seq[i:j])
            dev = [self.to_device(b) for b in uniq]
            copy_s += time.perf_counter() - t0
            set_lr(state.optimizer, self.scheduler.lr)
            key = ("train", sigs[i], state_key(state, optimizer=True))
            gens = [g for g in (state.dropout_gen, state.node_gen)
                    if g is not None]
            graph = self._step_graph(key, state, self._train_loss,
                                     dev[idxs[0]], gens)
            out = torch.empty(j - i, dtype=torch.float32, device=self.device)
            events = []
            for k, slot in enumerate(idxs):
                graph.load(dev[slot])
                t0 = time.perf_counter()
                if cuda and not graph.captured:
                    out[k] = graph.step(state)
                    capture_s += time.perf_counter() - t0
                elif cuda:
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    out[k] = graph.step(state)
                    ev[1].record()
                    events.append(ev)
                else:
                    out[k] = graph.step(state)
                    step_s.append(time.perf_counter() - t0)
            losses.extend(out.tolist())   # the run's one read
            step_s.extend(a.elapsed_time(b) / 1e3 for a, b in events)
            # a state's first step makes Adam's moments: key on them
            self._rekey(key, ("train", sigs[i],
                              state_key(state, optimizer=True)))
        return losses, copy_s, step_s, capture_s

    def _step_graph(self, key, state: TrainState, fn, example: GraphBatch,
                    generators) -> StepGraph:
        """The cached ``StepGraph`` of ``key``, else a new one (the oldest
        dropped past MAX_GRAPHS); a model's graphs go when it does."""
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            return graph
        while len(self._graphs) >= self.MAX_GRAPHS:
            self._graphs.popitem(last=False)
        graph = self._graphs[key] = StepGraph(fn, example, generators)
        mid = id(state.model)
        if mid not in self._finalizers or not self._finalizers[mid].alive:
            self._finalizers[mid] = weakref.finalize(
                state.model, _drop_graphs, weakref.ref(self), mid)
        return graph

    def _rekey(self, old, new) -> None:
        if old != new and old in self._graphs:
            self._graphs[new] = self._graphs.pop(old)

    def _eval_plan(self, graphs: List[Dict], n_iters: Optional[int]):
        """Eval batches are deterministic (no shuffle, fixed caps), so
        they are built and moved to the device once per split and reused
        every evaluation: (host batches, device batches).  Keyed by the
        (live) list object; at most 8 splits are kept."""
        key = (id(graphs), len(graphs), n_iters)
        plan = self._eval_plans.get(key)
        # the cached entry keeps a strong reference to the list, so its
        # id cannot be recycled while cached; the `is` check guards the
        # eviction race (a new list reusing an evicted entry's id)
        if plan is not None and plan[0] is graphs:
            return plan[1], plan[2]
        hosts = self._eval_batches(graphs, n_iters)
        batches = [self.to_device(b) for b in hosts]
        if len(self._eval_plans) >= 8:
            self._eval_plans.pop(next(iter(self._eval_plans)))
        self._eval_plans[key] = (graphs, hosts, batches)
        return hosts, batches

    def _eval_batches(self, graphs: List[Dict],
                      n_iters: Optional[int]) -> List[GraphBatch]:
        # worst-mode caps come from the TRAIN split; a skewed eval split
        # can exceed them, so take the elementwise max with this split's
        # own tight caps
        caps = self.caps
        if caps is not None:
            tight = tight_epoch_caps(np.arange(len(graphs)), graphs,
                                     self.tcfg.batch_size)
            caps = tuple(max(a, b) for a, b in zip(caps, tight))
        batches = []
        for it_idx, data in enumerate(iterate_batches(
                graphs, self.tcfg.batch_size, shuffle=False, caps=caps,
                y_shape=self.y_shape, y_dtype=self.y_dtype,
                flow=self.flow)):
            if n_iters is not None and it_idx >= n_iters:
                break
            batches.append(data)
        return batches

    @torch.no_grad()
    def evaluate(self, state: TrainState, graphs: List[Dict],
                 n_iters: Optional[int] = None):
        """Returns (avg_loss, avg_metric).  avg_loss weights each batch
        loss by its graph count (reference test(), :198-206); the metric
        is the sum-reduction prediction fn over |D|, or the evaluator
        (ROC-AUC) on the split's concatenated predictions."""
        if self.tcfg.evaluator not in (None, "rocauc"):
            raise ValueError(f"unknown evaluator {self.tcfg.evaluator!r}")
        state.model.eval()
        hosts, batches = self._eval_plan(graphs, n_iters)
        per_batch = (self._eval_runs(state, hosts, batches)
                     if self.tcfg.scan_epochs
                     else self._eval_steps(state, batches))
        total_loss = total_acc = 0.0
        total_n = 0
        y_true_all, y_pred_all = [], []
        for loss, n, acc, y_true, y_pred in per_batch:
            total_loss += loss * n
            total_acc += acc
            total_n += n
            if self.tcfg.evaluator is not None:
                y_true_all.append(y_true)
                y_pred_all.append(y_pred)
        avg_loss = total_loss / max(total_n, 1)
        if self.tcfg.evaluator == "rocauc":
            return avg_loss, roc_auc_score(np.concatenate(y_true_all),
                                           np.concatenate(y_pred_all))
        return avg_loss, total_acc / max(total_n, 1)

    def _eval_steps(self, state: TrainState, batches: List[GraphBatch]):
        """Per batch (loss, graphs, metric sum, y_true, y_pred; the last
        two for the evaluator), each read back as it is computed."""
        out = []
        for data in batches:
            y_hat = state.model(data)
            n, acc = self._eval_sums(y_hat, data)
            n, acc = int(n), float(acc)
            loss = float(self._step_loss(y_hat, data))
            y_true = y_pred = None
            if self.tcfg.evaluator is not None:
                y_hat, y, mask = (t.cpu().numpy()
                                  for t in self._eval_pack(y_hat, data))
                y_true, y_pred = y[mask], y_hat[mask]
            out.append((loss, n, acc, y_true, y_pred))
        return out

    @torch.no_grad()
    def _eval_row(self, state: TrainState, data: GraphBatch
                  ) -> torch.Tensor:
        """f32 [loss, graphs, metric sum] of one batch, then, when there
        is an evaluator, its ``_eval_pack`` flattened: what an eval graph
        captures."""
        y_hat = state.model(data)
        parts = [self._step_loss(y_hat, data), *self._eval_sums(y_hat, data)]
        if self.tcfg.evaluator is not None:
            parts += self._eval_pack(y_hat, data)
        return torch.cat([p.reshape(-1).to(torch.float32) for p in parts])

    def _unpack(self, pack: np.ndarray, data: GraphBatch):
        """(y_true, y_pred) of the real graphs from an eval row's
        ``_eval_pack`` part, for a host batch ``data``: predictions, labels
        (in their host dtype) and the mask, each over ``_pack_ranks``
        shards' graph slots."""
        g = self._pack_ranks * data.num_graph_slots
        y_shape = (g,) + data.y.shape[1:]
        n_y = int(np.prod(y_shape))
        mask = pack[-g:] != 0
        y = pack[-g - n_y:-g].reshape(y_shape).astype(data.y.dtype)
        return y[mask], pack[:-g - n_y].reshape((g, -1))[mask]

    def _eval_runs(self, state: TrainState, hosts: List[GraphBatch],
                   batches: List[GraphBatch]):
        """``_eval_steps``'s numbers from the runs of same-shape batches,
        each step a replay of the state's eval graph for its signature;
        the split's rows are read back at once (the same f32 values, so
        the host sums are the per-step path's; the evaluator's labels
        and mask come from the row, which holds every dp rank's)."""
        bufs = []
        sigs = [batch_sig(b) for b in hosts]
        self._check_runs(sigs)
        for i, j in runs(sigs):
            graph = self._step_graph(
                ("eval", sigs[i], state_key(state, optimizer=False)), state,
                self._eval_row, batches[i], ())
            buf = None
            for k in range(i, j):
                graph.load(batches[k])
                row = graph.step(state)
                if buf is None:
                    buf = row.new_empty(j - i, row.numel())
                buf[k - i] = row
            bufs.append(buf)
        if not bufs:
            return []
        flat = torch.cat([b.reshape(-1) for b in bufs]).cpu().numpy()
        out, at = [], 0
        for (i, j), buf in zip(runs(sigs), bufs):
            rows = flat[at:at + buf.numel()].reshape(buf.shape)
            at += buf.numel()
            for data, row in zip(hosts[i:j], rows):
                y_true = y_pred = None
                if self.tcfg.evaluator is not None:
                    y_true, y_pred = self._unpack(row[3:], data)
                out.append((float(row[0]), int(row[1]), float(row[2]),
                            y_true, y_pred))
        return out

    def fit(self, state: TrainState, graphs_train: List[Dict],
            graphs_test: List[Dict],
            graphs_val: Optional[List[Dict]] = None,
            checkpoint_file: Optional[str] = None,
            log_fn: Optional[Callable] = print,
            logger=None):
        """Full training loop (reference train(), train_test_funcs.py:48-174):
        from ``state.epoch`` to ``num_epochs``, StepLR stepped every
        epoch; every ``eval_frequency`` epochs the train, test and val
        splits are evaluated, Plateau steps on the val loss (the test
        loss without a val split), the record goes to ``logger`` and a
        checkpoint to ``checkpoint_file``; the loop stops once the lr
        falls below ``min_lr``.

        Returns (state, history dict of per-eval losses/metrics)."""
        hist = {"train_losses": [], "train_accs": [], "test_losses": [],
                "test_accs": [], "val_losses": [], "val_accs": []}
        t = self.tcfg
        for epoch in range(state.epoch, t.num_epochs):
            state, _ = self.train_epoch(state, graphs_train)
            if isinstance(self.scheduler, StepLR):
                self.scheduler.step()

            if epoch % t.eval_frequency == 0:
                t0 = time.perf_counter()
                train_loss, train_acc = self.evaluate(
                    state, graphs_train, t.num_iters_test)
                test_loss, test_acc = self.evaluate(
                    state, graphs_test, t.num_iters_test)
                hist["train_losses"].append(train_loss)
                hist["train_accs"].append(train_acc)
                hist["test_losses"].append(test_loss)
                hist["test_accs"].append(test_acc)
                if graphs_val is not None:
                    val_loss, val_acc = self.evaluate(
                        state, graphs_val, t.num_iters_test)
                    hist["val_losses"].append(val_loss)
                    hist["val_accs"].append(val_acc)
                eval_s = time.perf_counter() - t0
                if isinstance(self.scheduler, ReduceLROnPlateau):
                    ref = (hist["val_losses"][-1] if graphs_val is not None
                           else test_loss)
                    self.scheduler.step(ref)
                if logger is not None:
                    rec = {"train_loss": train_loss, "train_acc": train_acc,
                           "test_loss": test_loss, "test_acc": test_acc,
                           "lr": self.scheduler.lr, "eval_s": eval_s,
                           **self.epoch_stats}
                    if graphs_val is not None:
                        rec["val_loss"] = hist["val_losses"][-1]
                        rec["val_acc"] = hist["val_accs"][-1]
                    logger.log(rec, step=epoch)
                if log_fn:
                    msg = (f"Epoch: {epoch:03d}, Train: {train_acc:.4f}, "
                           f"Test: {test_acc:.4f}")
                    if graphs_val is not None:
                        msg += (f", Val: {hist['val_accs'][-1]:.4f}, "
                                f"Val Loss: {hist['val_losses'][-1]:.4f}")
                    msg += f", lr: {self.scheduler.lr:.8f}"
                    log_fn(msg)
                if checkpoint_file:
                    save_checkpoint(checkpoint_file, state, self.scheduler,
                                    self.rng)

            if self.scheduler.lr < t.min_lr:
                break
        return state, hist


def _drop_graphs(trainer_ref, model_id: int) -> None:
    """Drop a trainer's captured steps of a model that is gone."""
    trainer = trainer_ref()
    if trainer is not None:
        for key in [k for k in trainer._graphs if k[2][0] == model_id]:
            del trainer._graphs[key]
