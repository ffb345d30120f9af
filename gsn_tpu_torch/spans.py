"""The program's spans and counters: one recorder for set-up, the epoch
loop and the step graphs.

``span(name)`` times a block on ``time.perf_counter_ns`` and keeps, per
name, the total, the self time (the total less what the spans opened
inside it cover) and how many closed, for the whole process; the latest
closed spans are kept as (name, start ns, end ns, parent name) in
``recent``.  While a ``torch.profiler`` is recording, a span is also a
``record_function`` range of the same name, so the profiler's trace and
the spans share one clock; otherwise it makes no profiler call.
``count(name, n)`` adds to a counter.  ``snapshot()`` and ``since()``
give the spans and counters of a stretch of the run (an epoch), as
``Trainer.train_epoch`` and ``Trainer.fit`` write them into
``epoch_stats`` and the epoch's record.

The names (set-up: ``kernels.build``, ``data.count``, ``data.encode``,
``model.init``; each ``fit`` epoch: ``fit.epoch`` > ``train.epoch``,
``eval``, ``fit.checkpoint``; ``train.epoch`` > ``train.batch``,
``train.plan``, ``train.copy``, ``train.capture``, ``train.load``,
``train.launch``, ``train.read``; ``evaluate`` > ``eval.plan``,
``eval.capture``, ``eval.load``, ``eval.launch``, ``eval.read``,
``eval.unpack``, ``eval.metric``) are what ``PERF.md`` and the
benchmark's metrics read.

One thread records: the spans nest on one stack.  ``step_hist`` (in
``epoch_stats``) is a sparse histogram of step seconds in log-spaced
bins 1% wide (``hist_add``), which ``hist_quantile`` pools.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch.autograd.profiler as _prof

_now = time.perf_counter_ns

# name -> [total ns, self ns, spans closed], over the whole process
_totals: Dict[str, List[int]] = collections.defaultdict(lambda: [0, 0, 0])
_counts: Dict[str, int] = {}
# the open spans, innermost last
_open: List["span"] = []
# the latest closed spans: (name, start ns, end ns, parent name or None)
recent: "collections.deque" = collections.deque(maxlen=1 << 12)
_keep = recent.append


class span:
    """``with span(name) as s:`` times the block; ``s.seconds`` after."""

    __slots__ = ("name", "start", "end", "child", "rf")

    def __init__(self, name: str):
        self.name = name
        self.child = 0
        self.rf = None

    def __enter__(self) -> "span":
        if _prof._is_profiler_enabled:
            self.rf = _prof.record_function(self.name)
            self.rf.__enter__()
        _open.append(self)
        self.start = _now()
        return self

    def __exit__(self, _type, _value, _tb) -> bool:
        end = self.end = _now()
        _open.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        dur = end - self.start
        if _open:
            parent = _open[-1]
            parent.child += dur
            parent = parent.name
        else:
            parent = None
        t = _totals[self.name]
        t[0] += dur
        t[1] += dur - self.child
        t[2] += 1
        _keep((self.name, self.start, end, parent))
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def totals() -> Dict[str, List[float]]:
    """The process's spans: {name: [seconds, self seconds, closed]}."""
    return {k: [v[0] * 1e-9, v[1] * 1e-9, v[2]] for k, v in _totals.items()}


Snapshot = Tuple[Dict[str, Tuple[int, int, int]], Dict[str, int]]


def snapshot() -> Snapshot:
    return {k: tuple(v) for k, v in _totals.items()}, dict(_counts)


def since(snap: Snapshot) -> Tuple[Dict[str, List[float]], Dict[str, int]]:
    """(spans, counters) closed or counted after ``snap``: {name:
    [seconds, self seconds, closed]} and {name: n}, the names that
    moved."""
    t0, c0 = snap
    out = {}
    for k, v in _totals.items():
        a = t0.get(k, (0, 0, 0))
        if v[2] != a[2]:
            out[k] = [(v[0] - a[0]) * 1e-9, (v[1] - a[1]) * 1e-9,
                      v[2] - a[2]]
    return out, {k: v - c0.get(k, 0) for k, v in _counts.items()
                 if v != c0.get(k, 0)}


HIST_BASE = 1.01
_LOG_BASE = math.log(HIST_BASE)


def hist_add(hist: Dict[int, int], seconds: float) -> None:
    """One sample into ``hist``: bin ``b`` holds [1.01**b, 1.01**(b+1))
    seconds."""
    if seconds > 0:
        b = math.floor(math.log(seconds) / _LOG_BASE)
        hist[b] = hist.get(b, 0) + 1


def hist_quantile(hists: Iterable[Dict], q: float) -> Optional[float]:
    """The nearest-rank ``q`` quantile of the pooled histograms (keys
    ints, or strings as JSON gives them back): the geometric middle of
    its bin, within 0.5% of the sample; None when they are empty."""
    pooled: Dict[int, int] = collections.Counter()
    for h in hists:
        for b, n in h.items():
            pooled[int(b)] += n
    total = sum(pooled.values())
    if not total:
        return None
    rank = max(1, math.ceil(q * total - 1e-9))
    seen = 0
    for b in sorted(pooled):
        seen += pooled[b]
        if seen >= rank:
            return HIST_BASE ** (b + 0.5)
