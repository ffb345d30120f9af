"""Finds the benchmark's files by the names in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``reference/<config>.py``, ``work/<config>.py``,
``metrics/<metric>.py`` and, by the ``driver`` a configuration file
names, ``drivers/<driver>.py``.  A later cell, configuration, driver or
metric is a new file and a new entry, never an edit here."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
_MODULES = {}


def path(kind: str, name: str, ext: str) -> str:
    return os.path.join(HERE, kind, f"{name}.{ext}")


def data(kind: str, name: str) -> dict:
    with open(path(kind, name, "json")) as f:
        return json.load(f)


def module(kind: str, name: str):
    """``<kind>/<name>.py`` loaded once (its folder on the path, so its
    siblings import by name)."""
    key = (kind, name)
    if key not in _MODULES:
        folder = os.path.join(HERE, kind)
        if folder not in sys.path:
            sys.path.insert(0, folder)
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name}".replace("-", "_"), path(kind, name, "py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str):
    """(workload entry, configuration, traffic) of cell ``name``."""
    spec = benchmark()
    work = next(w for w in spec["workloads"] if w["name"] == name)
    return work, data("configs", work["config"]), data("traffic",
                                                       work["traffic"])
