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
"""

from __future__ import annotations

import copy
import dataclasses
import statistics
import time
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
from .metrics import LOSSES, PREDICTION_FNS, roc_auc_score
from .optim import ReduceLROnPlateau, StepLR, make_optimizer, make_scheduler


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
    # the reference's kernel layout and one-dispatch epochs: accepted for
    # its configurations, with no effect here (on the card the kernels
    # always run, and every step is its own call)
    use_mxu_segment_sum: object = False
    scan_epochs: bool = True


class Trainer:
    """Owns the model config, loss, scheduler and batching policy; the
    model and optimizer live in the ``TrainState`` from ``init_state``.

    ``model`` (as in the reference trainer) is a module to train in
    place of ``build_model(model_cfg)``, e.g. ``DGNNet(cfg)``; each
    ``init_state`` trains a copy of it with fresh weights."""

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
        # the last train_epoch's host and step times (seconds)
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
                             self.tcfg.regularization)
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
        model, opt = state.model, state.optimizer
        model.train()
        for group in opt.param_groups:
            group["lr"] = self.scheduler.lr if lr is None else lr
        opt.zero_grad(set_to_none=True)
        loss = self._step_loss(model(data, state.generators), data)
        self._backward(loss, model)
        opt.step()
        return state, loss.detach()

    def _step_loss(self, y_hat, data: GraphBatch) -> torch.Tensor:
        """The batch's loss (the parallel trainer's is global)."""
        return self.loss_fn(y_hat, data.y, data.graph_mask)

    def _backward(self, loss: torch.Tensor, model) -> None:
        """Fill the parameters' gradients (the parallel trainer also sums
        them over the ranks)."""
        loss.backward()

    def _eval_counts(self, y_hat, data: GraphBatch):
        """(graphs, metric sum) of one eval batch (global totals under
        the parallel trainer)."""
        n = int(data.graph_mask.sum())
        acc = (float(self.pred_fn(y_hat, data.y, data.graph_mask))
               if self.pred_fn is not None else 0.0)
        return n, acc

    def _eval_pack(self, y_hat, data: GraphBatch):
        """(y_hat, y, graph_mask) for evaluator metrics on the whole
        split (every rank's rows under data parallelism)."""
        return y_hat, data.y, data.graph_mask

    def _train_batches(self, graphs: List[Dict]) -> List[GraphBatch]:
        """One epoch's (shuffled) host batches."""
        return list(iterate_batches(
            graphs, self.tcfg.batch_size, shuffle=self.tcfg.shuffle,
            rng=self.rng, caps=self.caps, y_shape=self.y_shape,
            y_dtype=self.y_dtype, flow=self.flow))

    def train_epoch(self, state: TrainState, graphs: List[Dict]):
        """One epoch of ``num_iters`` steps (default: every batch once;
        more wrap around to the first batch).  Returns (state, mean
        loss) and leaves the epoch's host batching, copy and step times
        in ``epoch_stats``."""
        t0 = time.perf_counter()
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
        losses, copy_s, step_s = [], [], []
        for data in seq:
            t0 = time.perf_counter()
            data = self.to_device(data)
            t1 = time.perf_counter()
            state, loss = self.train_step(state, data)
            losses.append(float(loss))   # waits for the step
            copy_s.append(t1 - t0)
            step_s.append(time.perf_counter() - t1)
        self.epoch_stats = dict(
            epoch_s=build_s + sum(copy_s) + sum(step_s), steps=len(seq),
            host_batch_s=build_s + sum(copy_s),
            step_median_s=statistics.median(step_s) if step_s else 0.0)
        state = dataclasses.replace(state, epoch=state.epoch + 1)
        return state, float(np.mean(losses)) if losses else 0.0

    def _eval_plan(self, graphs: List[Dict],
                   n_iters: Optional[int]) -> List[GraphBatch]:
        """Eval batches are deterministic (no shuffle, fixed caps), so
        they are built and moved to the device once per split and reused
        every evaluation.  Keyed by the (live) list object; at most 8
        splits are kept."""
        key = (id(graphs), len(graphs), n_iters)
        plan = self._eval_plans.get(key)
        # the cached entry keeps a strong reference to the list, so its
        # id cannot be recycled while cached; the `is` check guards the
        # eviction race (a new list reusing an evicted entry's id)
        if plan is not None and plan[0] is graphs:
            return plan[1]
        batches = [self.to_device(b)
                   for b in self._eval_batches(graphs, n_iters)]
        if len(self._eval_plans) >= 8:
            self._eval_plans.pop(next(iter(self._eval_plans)))
        self._eval_plans[key] = (graphs, batches)
        return batches

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
        model = state.model
        model.eval()
        total_loss = total_acc = 0.0
        total_n = 0
        y_true_all, y_pred_all = [], []
        for data in self._eval_plan(graphs, n_iters):
            y_hat = model(data)
            n, acc = self._eval_counts(y_hat, data)
            total_loss += float(self._step_loss(y_hat, data)) * n
            total_acc += acc
            total_n += n
            if self.tcfg.evaluator is not None:
                y_hat, y, mask = (t.cpu().numpy()
                                  for t in self._eval_pack(y_hat, data))
                y_true_all.append(y[mask])
                y_pred_all.append(y_hat[mask])
        avg_loss = total_loss / max(total_n, 1)
        if self.tcfg.evaluator == "rocauc":
            return avg_loss, roc_auc_score(np.concatenate(y_true_all),
                                           np.concatenate(y_pred_all))
        return avg_loss, total_acc / max(total_n, 1)

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
