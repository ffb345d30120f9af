"""The epoch executor's pieces (counterpart of the scanned epochs of
``gsn_tpu/train/loop.py:182-350``): runs of same-shape batches, and a
step captured once as a CUDA graph and replayed over a run.

The reference runs each contiguous run of batches with one shape
signature as ONE ``lax.scan`` dispatch.  Its counterpart on the card is
one ``torch.cuda.CUDAGraph`` per (state, signature, train | eval): the
whole step (forward with the hand-written kernels, loss, backward and
the capturable Adam; or the eval forward and its per-batch numbers) is
captured at the start of the first run of its signature and replayed
once a step, each batch first copied device-to-device into the graph's
static input buffers.  On the CPU there are no graphs: the same static
buffers feed the eager step, so the CPU runs all of this but the
capture.

A capture is preceded by one eager step of the run on a side stream
(PyTorch's whole-network capture recipe): it is a real step, the run's
first, and it builds the kernels, creates Adam's moments and warms the
libraries before anything is recorded.  A capture or a replay that
fails raises; nothing falls back to per-step calls.

The kernel wrappers count their launches in Python (``ops/cuda/
build.py``), which a replay never runs: a capture records the launches
it holds (and takes them back off the counts, since a capture launches
nothing), and each replay adds them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from gsn_tpu_torch.graphs.container import GraphBatch
from gsn_tpu_torch.ops.cuda import build

# GraphBatch fields that are host values, not arrays: they never enter a
# signature, and a static batch keeps its capture's values (the step
# reads none of them but the strings, which the signature holds)
HOST_FIELDS = ("num_real_edges",)


def _leaf_sig(v):
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return tuple(v.shape), str(v.dtype).replace("torch.", "")
    return v


def batch_sig(data: GraphBatch) -> Tuple:
    """The shapes and dtypes of a batch's arrays (and its string fields):
    what a captured step's static buffers fix.  The real edge count is a
    host int, not part of it (``graphs/container.py``)."""
    return tuple((f.name, _leaf_sig(getattr(data, f.name)))
                 for f in dataclasses.fields(data)
                 if f.name not in HOST_FIELDS)


def runs(sigs: Sequence) -> Iterator[Tuple[int, int]]:
    """Contiguous [i, j) runs of equal signature, in order (reference
    ``Trainer._runs``)."""
    i = 0
    while i < len(sigs):
        j = i + 1
        while j < len(sigs) and sigs[j] == sigs[i]:
            j += 1
        yield i, j
        i = j


def unique_slots(batches: Sequence) -> Tuple[List, List[int]]:
    """(the distinct batch objects in first-seen order, each position's
    slot among them): a wrap-around iteration reuses its batch's slot
    (reference ``train_epoch``'s ``uniq``/``idxs``)."""
    uniq, idxs, slot = [], [], {}
    for b in batches:
        if id(b) not in slot:
            slot[id(b)] = len(uniq)
            uniq.append(b)
        idxs.append(slot[id(b)])
    return uniq, idxs


def tensor_fields(data: GraphBatch) -> List[str]:
    return [f.name for f in dataclasses.fields(data)
            if isinstance(getattr(data, f.name), torch.Tensor)]


class StepGraph:
    """One step function ``fn(state, batch) -> tensor`` over static input
    buffers shaped like ``example`` (a batch on the device).

    ``load`` copies a batch of the same signature into the buffers;
    ``step`` runs the step on them and returns its output tensor.  On a
    CUDA device the first ``step`` runs ``fn`` eagerly on a side stream
    (a real step, returned) and then captures it, registering
    ``generators`` (the dropout streams) so each replay advances their
    Philox offsets as an eager step would; every later ``step`` is one
    replay, whose output is the static tensor the capture returned.  On
    the CPU ``step`` calls ``fn``.  Holds no reference to a state: the
    caller passes it to every ``step``."""

    def __init__(self, fn: Callable, example: GraphBatch,
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.generators = list(generators)
        self.names = tensor_fields(example)
        self.static = dataclasses.replace(example, **{
            n: getattr(example, n).clone() for n in self.names})
        self.device = example.x.device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        # the launches one replay makes, by wrapper (build.since)
        self.launches: Dict = {}

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def load(self, data: GraphBatch) -> None:
        for n in self.names:
            getattr(self.static, n).copy_(getattr(data, n),
                                          non_blocking=True)

    def step(self, state) -> torch.Tensor:
        if self.device.type != "cuda":
            return self.fn(state, self.static)
        if self.graph is None:
            return self._capture(state)
        self.graph.replay()
        build.add(self.launches)
        return self.out

    def _capture(self, state) -> torch.Tensor:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self.fn(state, self.static)
        cur.wait_stream(side)
        first.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        snap = build.snapshot()
        try:
            with torch.cuda.graph(graph):
                out = self.fn(state, self.static)
            self.launches = build.since(snap)
        finally:
            build.restore(snap)
        self.graph, self.out = graph, out
        return first


def state_key(state, optimizer: bool) -> Tuple:
    """What a captured step of ``state`` is bound to: its model,
    generators and, with ``optimizer``, its optimizer (objects), and the
    storage of every tensor the step reads or writes (parameters, BN
    statistics, Adam's moments and steps, the rate tensor).  A new
    ``init_state`` or a loaded checkpoint changes it, so no graph is
    replayed on storage it was not captured for."""
    model = state.model
    tensors = [*model.parameters(), *model.buffers()]
    opt_id = None
    if optimizer:
        opt = state.optimizer
        opt_id = id(opt)
        for s in opt.state.values():
            tensors += [v for v in s.values() if torch.is_tensor(v)]
        for group in opt.param_groups:
            tensors += [v for k, v in group.items()
                        if k != "params" and torch.is_tensor(v)]
    return (id(model), opt_id, id(state.dropout_gen), id(state.node_gen),
            tuple(t.data_ptr() for t in tensors))
