"""Build and load the port's CUDA kernels.

Each source in ``gsn_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface under
``build/`` at the repository root, and loaded with ``ctypes``.  A build
happens at first use (or when the source or a header is newer than the
library); ``build_all`` starts one ``nvcc`` per source at once, so a
cold start pays for the slowest file, not the sum.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a nonzero code into an exception.  ``on_cuda`` and
``require`` are the wrappers' shared dispatch and argument checks, and
``counted``/``count`` their launch counts; ``snapshot``, ``since``,
``restore`` and ``add`` let a CUDA graph's capture record the launches
it holds and each replay add them (``train/graphs.py``).  K1–K4 take
f32 or bf16 data
(one dtype for all of a call's data operands); K5/K6 take f32 or bf16
rows with f32 weights, maxima and counts.
``build_other`` and ``use`` build another source tree's kernel beside
this one's and route the wrappers' launches to it, to time two builds
on one card.
Nothing here runs on import, so hosts without ``nvcc`` or a card import
it freely.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, List

from gsn_tpu_torch.spans import span

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(os.path.dirname(_HERE))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int

# C signature of every entry point: (source, symbol) -> argtypes
SIGNATURES: Dict[str, Dict[str, List]] = {
    "edge_message": {
        "gsn_edge_message_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, P],
        "gsn_edge_message_bwd_recv": [P, P, P, P, P, P, P, P, P,
                                      I, I, I, I, I, P],
        "gsn_edge_message_fwd_bf16": [P, P, P, P, P, P, P,
                                      I, I, I, I, I, P],
        "gsn_edge_message_bwd_recv_bf16": [P, P, P, P, P, P, P, P, P,
                                           I, I, I, I, I, P],
    },
    "segment_sum": {
        "gsn_segment_sum_sorted": [P, P, P, P, I, I, I, P],
        "gsn_segment_sum_sorted_bf16": [P, P, P, P, I, I, I, I, P],
        "gsn_segment_sum_sorted_f32_bf16": [P, P, P, P, I, I, I, P],
    },
    "segment_broadcast": {
        "gsn_segment_broadcast": [P, P, I, P, I, I, P],
        "gsn_segment_broadcast_bf16": [P, P, I, P, I, I, P],
        "gsn_segment_broadcast_occupancy": [I, I],
        "gsn_segment_broadcast_occupancy_bf16": [I, I],
    },
    "dgn_aggregate": {
        "gsn_dgn_aggregate_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, P],
        "gsn_dgn_aggregate_bwd": [P, P, P, P, P, P, P, P, P, P,
                                  I, I, I, I, I, I, P],
        "gsn_dgn_aggregate_fwd_bf16": [P, P, P, P, P, P, P,
                                       I, I, I, I, I, P],
        "gsn_dgn_aggregate_bwd_bf16": [P, P, P, P, P, P, P, P, P, P,
                                       I, I, I, I, I, I, P],
        "gsn_dgn_aggregate_occupancy": [I, I, I, I, I, I, I],
        "gsn_dgn_aggregate_occupancy_bf16": [I, I, I, I, I, I],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas register/spill report of each build, for the smoke log
build_logs: Dict[str, str] = {}


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise KernelError("nvcc not found (set CUDA_HOME or PATH)")
    return path


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _so_path(name)
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    deps = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
            if f == f"{name}.cu" or f.endswith(".cuh")]
    return any(os.path.getmtime(p) > built for p in deps)


def _start(name: str, csrc: str = CSRC, stem: str = "") -> subprocess.Popen:
    """Start compiling ``<csrc>/<name>.cu`` into ``lib<stem>.so``
    (``stem`` defaults to ``name``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = stem or name
    tmp = f"{_so_path(stem)}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(csrc, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.stem = tmp, stem
    return proc


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    build_logs[proc.stem] = out
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(proc.tmp, _so_path(proc.stem))


def _load(name: str, stem: str = "") -> ctypes.CDLL:
    lib = ctypes.CDLL(_so_path(stem or name))
    for sym, argtypes in SIGNATURES[name].items():
        if stem and not hasattr(lib, sym):
            continue  # another tree's build may predate an entry point
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_all() -> float:
    """Compile every stale source in parallel and load all libraries.
    Returns the wall seconds spent (the ``kernels.build`` span)."""
    with span("kernels.build") as s, _lock:
        procs = {n: _start(n) for n in SIGNATURES if _stale(n)}
        try:
            for n, p in procs.items():
                _finish(n, p)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for n in SIGNATURES:
            if n not in _libs:
                _libs[n] = _load(n)
    return s.seconds


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        with _lock:
            if name not in _libs:
                if _stale(name):
                    _finish(name, _start(name))
                _libs[name] = _load(name)
    return _libs[name]


def build_other(name: str, csrc: str) -> ctypes.CDLL:
    """Build ``<csrc>/<name>.cu`` of another source tree (with that
    tree's headers) into ``build/lib<name>_other.so`` and load it with
    the entry points of ``name`` that it has."""
    stem = f"{name}_other"
    with _lock:
        _finish(name, _start(name, csrc, stem))
    return _load(name, stem)


@contextlib.contextmanager
def use(name: str, other: ctypes.CDLL):
    """Inside the block, the wrappers launch ``name``'s kernels from the
    library ``other`` (one ``build_other`` returned)."""
    own = lib(name)
    _libs[name] = other
    try:
        yield
    finally:
        _libs[name] = own


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def on_cuda(t) -> bool:
    """Dispatch rule of every wrapper: a CPU tensor takes the plain
    version, a CUDA tensor the kernel; any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {t.device}")


def dtype_name(dtype) -> str:
    """``f32`` / ``bf16`` (else the dtype's own name), for messages and
    launch modes."""
    return {"torch.float32": "f32", "torch.bfloat16": "bf16"}.get(
        str(dtype), str(dtype))


def require(what, device, *tensors, dtype=None) -> None:
    """Raise unless every given tensor (None entries skipped) lies on
    ``device`` and is contiguous and, when ``dtype`` is set, has it.
    ``dtype`` may be a tuple of the dtypes a kernel takes: the tensors
    must then share one of them (there is no cast)."""
    given = [t for t in tensors if t is not None]
    for t in given:
        if t.device != device:
            raise ValueError(f"{what}: tensor on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor is not contiguous")
    if dtype is None:
        return
    accepted = dtype if isinstance(dtype, tuple) else (dtype,)
    found = list(dict.fromkeys(t.dtype for t in given))
    if len(found) > 1 or any(d not in accepted for d in found):
        names = " and ".join(dtype_name(d) for d in found)
        raise TypeError(f"{what}: dtype {names}, the kernel takes "
                        + " or ".join(dtype_name(d) for d in accepted)
                        + (", one for all data operands"
                           if len(accepted) > 1 else ""))


# every counted wrapper, in the order of definition
COUNTED: List = []


def counted(fn):
    """Give a kernel wrapper its launch counts: ``launches`` in all,
    ``modes``, launches by mode (the data dtypes, e.g. ``"bf16"`` or
    ``"bf16->f32"``), ``forms``, launches by the kernel's form where
    it has several (K3's ``"warp"`` and ``"block"``), and ``widths``,
    launches by (mode, row width) where the wrapper gives the width
    (K1, K2)."""
    reset(fn)
    COUNTED.append(fn)
    return fn


def reset(fn) -> None:
    """Zero the launch counts of a ``counted`` wrapper."""
    fn.launches, fn.modes, fn.forms, fn.widths = 0, {}, {}, {}


def count(fn, mode: str, form: str = "", width: int = 0) -> None:
    """One launch of ``fn``'s kernel in ``mode`` (and ``form``, where the
    kernel has several, and on rows of ``width`` elements, where the
    wrapper gives it); wrappers call it where they launch, and nowhere
    else."""
    fn.launches += 1
    fn.modes[mode] = fn.modes.get(mode, 0) + 1
    if form:
        fn.forms[form] = fn.forms.get(form, 0) + 1
    if width:
        key = (mode, width)
        fn.widths[key] = fn.widths.get(key, 0) + 1


_KEYS = ("modes", "forms", "widths")


def snapshot() -> Dict:
    """Every counted wrapper's counts, for ``since`` and ``restore``."""
    return {fn: (fn.launches, *(dict(getattr(fn, k)) for k in _KEYS))
            for fn in COUNTED}


def since(snap: Dict) -> Dict:
    """The launches each wrapper of ``snap`` counted after it, by key:
    what a CUDA graph's capture recorded (wrappers with none left out)."""
    out = {}
    for fn, (n, *maps) in snap.items():
        delta = [fn.launches - n]
        for key, old in zip(_KEYS, maps):
            new = getattr(fn, key)
            delta.append({k: c - old.get(k, 0) for k, c in new.items()
                          if c != old.get(k, 0)})
        if delta[0] or any(delta[1:]):
            out[fn] = tuple(delta)
    return out


def restore(snap: Dict) -> None:
    """Put back the counts of ``snap`` (a capture launched nothing)."""
    for fn, (n, *maps) in snap.items():
        fn.launches = n
        for key, old in zip(_KEYS, maps):
            setattr(fn, key, dict(old))


def add(deltas: Dict, times: int = 1) -> None:
    """Count ``times`` runs of the launches ``deltas`` (from ``since``):
    each replay of a captured graph launches what its capture held."""
    for fn, (n, *maps) in deltas.items():
        fn.launches += n * times
        for key, delta in zip(_KEYS, maps):
            counts = getattr(fn, key)
            for k, c in delta.items():
                counts[k] = counts.get(k, 0) + c * times


def ptr(t) -> int:
    """Device address of ``t`` for a ``c_void_p`` argument (0 for None)."""
    return 0 if t is None else t.data_ptr()
