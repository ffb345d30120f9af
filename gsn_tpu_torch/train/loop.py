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
Each batch is built, signed and copied after the step before it was
launched, so the host makes it while the card runs the replays before
it.  The losses of a run stay on the device and are read once a run; an
evaluation reads its per-batch numbers once a split.  A capture that
fails raises.  On the CPU the same runs drive the eager step.
``scan_epochs=False`` issues every step's launches from Python and
reads each loss back, as before.

What an epoch spent is recorded as spans and counters (``spans.py``):
``train_epoch`` leaves them in ``epoch_stats`` (its keys below), and
``fit`` adds its epoch's to the record it logs.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import statistics
import weakref
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from gsn_tpu_torch.graphs.batching import (EpochBatches, epoch_caps,
                                           infer_y_spec, iterate_batches,
                                           tight_epoch_caps)
from gsn_tpu_torch.graphs.container import GraphBatch
from gsn_tpu_torch.nn.init import init_parameters
from gsn_tpu_torch.nn.models import DropoutStreams, build_model
from gsn_tpu_torch.spans import count, hist_add, since, snapshot, span
from .checkpoint import save_checkpoint
from .graphs import StepGraph, batch_sig, runs, state_key
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
        # the last train_epoch's times, counters and spans (train_epoch)
        self.epoch_stats: Dict = {}
        # timing events, two a step, reused by every run (_train_runs)
        self._events: List = []

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh weights drawn from ``torch.Generator`` seeded with
        ``seed``, on the trainer's device, with a new optimizer; the
        dropout masks come from a generator on that device seeded with
        ``seed + 1`` (the reference's dropout key)."""
        with span("model.init"):
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
        """Before an evaluation's first run: nothing on one device (the
        parallel trainer checks that its ranks agree, and before its
        epochs' runs too)."""

    def _train_batches(self, graphs: List[Dict]) -> Sequence[GraphBatch]:
        """One epoch's host batches, their order drawn now; each is
        built when a step first asks for it (``EpochBatches``)."""
        return EpochBatches(
            graphs, self.tcfg.batch_size, shuffle=self.tcfg.shuffle,
            rng=self.rng, caps=self.caps, y_shape=self.y_shape,
            y_dtype=self.y_dtype, flow=self.flow)

    def train_epoch(self, state: TrainState, graphs: List[Dict]):
        """One epoch of ``num_iters`` steps (default: every batch once;
        more wrap around to the first batch).  Returns (state, mean
        loss) and leaves in ``epoch_stats``, from the epoch's spans and
        counters (``spans.py``): ``epoch_s`` (``train.epoch``),
        ``steps``, ``host_batch_s`` (``train.batch`` + ``train.copy``),
        ``step_median_s`` (a replay's device time under ``scan_epochs``
        on the card, else the host's), ``capture_s`` (``train.capture``:
        warm-up and capture; 0 once cached), ``step_hist`` (every timed
        step's seconds, ``spans.hist_add``), the counters ``TRAIN_COUNTS``
        (runs, captures, graphs evicted, real rows against slots of the
        steps' nodes, edges and graphs, the per-edge gathers built on
        the segment and the index route, and the steps fed after a
        replay, ``_train_runs``) and ``spans`` ({name: [seconds, self
        seconds, closed]} of ``train.epoch`` and what it holds).

        The host stream draws the epoch's shuffle, then one number a
        step; the batches are built after both, each as its step comes
        (``EpochSteps``)."""
        snap = snapshot()
        with span("train.epoch"):
            with span("train.batch"):
                batches = self._train_batches(graphs)
            n_iters = self.tcfg.num_iters or len(batches)
            for _ in range(n_iters):
                # the reference's per-iteration dropout key: drawn so
                # that later epochs' shuffles stay in step with its stream
                self.rng.randint(0, 2**31 - 1)
            run = (self._train_runs if self.tcfg.scan_epochs
                   else self._train_steps)
            losses, step_s = run(state, EpochSteps(batches, n_iters))
        spans, counts = since(snap)
        hist: Dict[int, int] = {}
        for s in step_s:
            hist_add(hist, s)

        def total(name):
            return spans.get(name, (0.0,))[0]

        self.epoch_stats = dict(
            epoch_s=total("train.epoch"), steps=n_iters,
            host_batch_s=total("train.batch") + total("train.copy"),
            step_median_s=statistics.median(step_s) if step_s else 0.0,
            capture_s=total("train.capture"), step_hist=hist,
            **{k: counts.get(k, 0) for k in TRAIN_COUNTS}, spans=spans)
        state = dataclasses.replace(state, epoch=state.epoch + 1)
        return state, float(np.mean(losses)) if losses else 0.0

    def _train_steps(self, state: TrainState, seq: Iterable[GraphBatch]):
        """Every step issued from Python, each loss read back: (losses,
        each step's host seconds, its launch and read)."""
        losses, step_s = [], []
        for data in seq:
            with span("train.copy"):
                data = self.to_device(data)
            with span("train.launch") as launch:
                state, loss = self.train_step(state, data)
            with span("train.read") as read:
                losses.append(float(loss))   # waits for the step
            step_s.append(launch.seconds + read.seconds)
        return losses, step_s

    def _train_runs(self, state: TrainState, seq: Iterable[GraphBatch]):
        """The runs of same-shape batches, each step a replay of the
        state's train graph for the run's signature (captured first
        where there is none): (losses, the timed steps' seconds: a
        replay's CUDA-event time, on the CPU the eager step's).

        ``seq`` (with a length) is taken a step at a time: a step's
        batch is built (where ``seq`` builds it), signed and copied once
        the step before it has been launched, so on the card it is made
        while the replays before it run.  A batch whose signature
        differs from its run's ends that run, with the run's one read,
        and opens the next; a wrap-around step reuses its batch's copy
        in the run.  A step fed after a replay of the epoch was launched
        counts as ``train.overlapped_batches``."""
        cuda = self.device.type == "cuda"
        losses, step_s = [], []
        out = torch.empty(len(seq), dtype=torch.float32, device=self.device)
        events = self._step_events(len(seq)) if cuda else None

        def read(run: _Run) -> None:
            with span("train.read"):
                losses.extend(out[run.start:run.end].tolist())
                step_s.extend(events[2 * k].elapsed_time(events[2 * k + 1])
                              / 1e3 for k in run.timed)
            # a state's first step makes Adam's moments: key on them
            self._rekey(run.key, ("train", run.sig,
                                  state_key(state, optimizer=True)))

        run = None
        replayed = False
        for k, data in enumerate(seq):
            if replayed:
                count("train.overlapped_batches")
            with span("train.plan"):
                sig = batch_sig(data)
            if run is not None and sig != run.sig:
                read(run)
                run = None
            with span("train.copy"):
                dev = run.dev.get(id(data)) if run is not None else None
                if dev is None:
                    dev = self.to_device(data)
            if run is None:
                run = self._start_run(state, sig, dev, k)
            run.dev[id(data)] = dev
            graph = run.graph
            replayed = replayed or graph.captured   # this step replays
            with span("train.load"):
                graph.load(dev)
            if cuda and not graph.captured:
                count("train.captures")
                with span("train.capture"):
                    out[k] = graph.step(state)
            elif cuda:
                with span("train.launch"):
                    events[2 * k].record()
                    out[k] = graph.step(state)
                    events[2 * k + 1].record()
                run.timed.append(k)
            else:
                with span("train.launch") as launch:
                    out[k] = graph.step(state)
                step_s.append(launch.seconds)
            run.end = k + 1
        if run is not None:
            read(run)
        return losses, step_s

    def _start_run(self, state: TrainState, sig, example: GraphBatch,
                   start: int) -> "_Run":
        """A run of signature ``sig`` from step ``start``: the rate set,
        the state's train graph for it (``example`` on the device)."""
        count("train.runs")
        set_lr(state.optimizer, self.scheduler.lr)
        key = ("train", sig, state_key(state, optimizer=True))
        gens = [g for g in (state.dropout_gen, state.node_gen)
                if g is not None]
        graph = self._step_graph(key, state, self._train_loss, example,
                                 gens)
        return _Run(sig, key, graph, start)

    def _step_events(self, n: int) -> List:
        """At least ``2 n`` timing events (a run's steps' starts and
        ends), made once and reused by every later run."""
        while len(self._events) < 2 * n:
            self._events.append(torch.cuda.Event(enable_timing=True))
        return self._events

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
            count("graphs.evicted")
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
        with span("eval.plan"):
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
        count("eval.steps", len(batches))
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
            with span("eval.metric"):
                return avg_loss, roc_auc_score(np.concatenate(y_true_all),
                                               np.concatenate(y_pred_all))
        return avg_loss, total_acc / max(total_n, 1)

    def _eval_steps(self, state: TrainState, batches: List[GraphBatch]):
        """Per batch (loss, graphs, metric sum, y_true, y_pred; the last
        two for the evaluator), each read back as it is computed."""
        out = []
        for data in batches:
            with span("eval.launch"):
                y_hat = state.model(data)
                n, acc = self._eval_sums(y_hat, data)
                loss = self._step_loss(y_hat, data)
            with span("eval.read"):
                n, acc, loss = int(n), float(acc), float(loss)
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
        cuda = self.device.type == "cuda"
        bufs = []
        with span("eval.plan"):
            sigs = [batch_sig(b) for b in hosts]
            self._check_runs(sigs)
        for i, j in runs(sigs):
            graph = self._step_graph(
                ("eval", sigs[i], state_key(state, optimizer=False)), state,
                self._eval_row, batches[i], ())
            buf = None
            for k in range(i, j):
                with span("eval.load"):
                    graph.load(batches[k])
                capture = cuda and not graph.captured
                if capture:
                    count("eval.captures")
                with span("eval.capture" if capture else "eval.launch"):
                    row = graph.step(state)
                    if buf is None:
                        buf = row.new_empty(j - i, row.numel())
                    buf[k - i] = row
            bufs.append(buf)
        if not bufs:
            return []
        with span("eval.read"):
            flat = torch.cat([b.reshape(-1) for b in bufs]).cpu().numpy()
        with span("eval.unpack"):
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

        The record of an evaluated epoch also holds ``eval_s`` (the
        ``eval`` span), the epoch's ``epoch_stats`` and, over the whole
        ``fit.epoch`` span, the counters ``FIT_COUNTS`` (``eval.steps``
        and ``eval.captures`` besides the train epoch's) and its
        ``spans``; it is logged once that span has closed, after the
        checkpoint.

        Returns (state, history dict of per-eval losses/metrics)."""
        hist = {"train_losses": [], "train_accs": [], "test_losses": [],
                "test_accs": [], "val_losses": [], "val_accs": []}
        t = self.tcfg
        for epoch in range(state.epoch, t.num_epochs):
            snap = snapshot()
            rec = None
            with span("fit.epoch"):
                state, _ = self.train_epoch(state, graphs_train)
                if isinstance(self.scheduler, StepLR):
                    self.scheduler.step()
                if epoch % t.eval_frequency == 0:
                    rec = self._fit_eval(state, graphs_train, graphs_test,
                                         graphs_val, hist, log_fn, epoch)
                    if checkpoint_file:
                        with span("fit.checkpoint"):
                            save_checkpoint(checkpoint_file, state,
                                            self.scheduler, self.rng)
            if rec is not None and logger is not None:
                spans, counts = since(snap)
                rec.update(self.epoch_stats)
                rec.update({k: counts.get(k, 0) for k in FIT_COUNTS})
                rec["spans"] = spans
                logger.log(rec, step=epoch)

            if self.scheduler.lr < t.min_lr:
                break
        return state, hist

    def _fit_eval(self, state: TrainState, graphs_train, graphs_test,
                  graphs_val, hist: Dict, log_fn, epoch: int) -> Dict:
        """``fit``'s evaluation of an epoch: the train, test and val
        splits (the ``eval`` span), Plateau's step, the printed line;
        returns the epoch's record so far."""
        t = self.tcfg
        with span("eval") as ev:
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
        if isinstance(self.scheduler, ReduceLROnPlateau):
            ref = (hist["val_losses"][-1] if graphs_val is not None
                   else test_loss)
            self.scheduler.step(ref)
        rec = {"train_loss": train_loss, "train_acc": train_acc,
               "test_loss": test_loss, "test_acc": test_acc,
               "lr": self.scheduler.lr, "eval_s": ev.seconds}
        if graphs_val is not None:
            rec["val_loss"] = hist["val_losses"][-1]
            rec["val_acc"] = hist["val_accs"][-1]
        if log_fn:
            msg = (f"Epoch: {epoch:03d}, Train: {train_acc:.4f}, "
                   f"Test: {test_acc:.4f}")
            if graphs_val is not None:
                msg += (f", Val: {hist['val_accs'][-1]:.4f}, "
                        f"Val Loss: {hist['val_losses'][-1]:.4f}")
            msg += f", lr: {self.scheduler.lr:.8f}"
            log_fn(msg)
        return rec


# the counters every epoch_stats holds (0 when nothing counted them);
# the per-edge gathers count as built (an eager step or a capture), not
# per replay
TRAIN_COUNTS = ("train.runs", "train.captures", "graphs.evicted",
                "train.real_nodes", "train.node_slots", "train.real_edges",
                "train.edge_slots", "train.real_graphs", "train.graph_slots",
                "edge_gather.segment", "edge_gather.index",
                "train.overlapped_batches")
# and every record of fit
FIT_COUNTS = TRAIN_COUNTS + ("eval.steps", "eval.captures")


class EpochSteps:
    """An epoch's ``n`` steps over ``batches``, wrapping around to the
    first: iterating gives each step's host batch as its step comes,
    got from ``batches`` there (which builds it the first time, for
    ``EpochBatches``) and its rows counted, in a ``train.batch``
    span."""

    def __init__(self, batches: Sequence[GraphBatch], n: int):
        self.batches, self.n = batches, n

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterator[GraphBatch]:
        for k in range(self.n):
            with span("train.batch"):
                data = self.batches[k % len(self.batches)]
                count_rows(data)
            yield data


@dataclasses.dataclass
class _Run:
    """A run of ``Trainer._train_runs`` while it is open: its signature,
    graph key and graph, its steps [start, end), the steps it timed and
    its batches' device copies by host batch."""
    sig: Tuple
    key: Tuple
    graph: StepGraph
    start: int
    end: int = 0
    timed: List[int] = dataclasses.field(default_factory=list)
    dev: Dict[int, GraphBatch] = dataclasses.field(default_factory=dict)


def count_rows(data: GraphBatch) -> None:
    """Count a step's real rows and slots (``train.real_nodes`` /
    ``train.node_slots``, edges, graphs): from the host batch's masks
    and ``num_real_edges``, never a device tensor."""
    count("train.real_nodes", int(np.count_nonzero(data.node_mask)))
    count("train.node_slots", data.num_node_slots)
    count("train.real_edges", data.num_real_edges)
    count("train.edge_slots", data.num_edge_slots)
    count("train.real_graphs", int(np.count_nonzero(data.graph_mask)))
    count("train.graph_slots", data.num_graph_slots)


def _drop_graphs(trainer_ref, model_id: int) -> None:
    """Drop a trainer's captured steps of a model that is gone."""
    trainer = trainer_ref()
    if trainer is not None:
        for key in [k for k in trainer._graphs if k[2][0] == model_id]:
            del trainer._graphs[key]
