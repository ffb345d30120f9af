"""Build and load the port's CUDA kernels.

Each source in ``gsn_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface under
``build/`` at the repository root, and loaded with ``ctypes``.  A build
happens at first use (or when the source or a header is newer than the
library); ``build_all`` starts one ``nvcc`` per source at once, so a
cold start pays for the slowest file, not the sum.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a nonzero code into an exception.  ``on_cuda`` and
``require`` are the wrappers' shared dispatch and argument checks.
Nothing here runs on import, so hosts without ``nvcc`` or a card import
it freely.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

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
    },
    "segment_sum": {
        "gsn_segment_sum_sorted": [P, P, P, P, I, I, P],
    },
    "segment_broadcast": {
        "gsn_segment_broadcast": [P, P, I, P, I, I, P],
    },
    "dgn_aggregate": {
        "gsn_dgn_aggregate_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, P],
        "gsn_dgn_aggregate_bwd": [P, P, P, P, P, P, P, P, P, P,
                                  I, I, I, I, I, I, P],
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


def _start(name: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_so_path(name)}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp
    return proc


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(proc.tmp, _so_path(name))


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(_so_path(name))
    for sym, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_all() -> float:
    """Compile every stale source in parallel and load all libraries.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
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
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        with _lock:
            if name not in _libs:
                if _stale(name):
                    _finish(name, _start(name))
                _libs[name] = _load(name)
    return _libs[name]


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


def require(what: str, device, *tensors, dtype=None) -> None:
    """Raise unless every given tensor (None entries skipped) lies on
    ``device``, is contiguous and, when ``dtype`` is set, has it."""
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: tensor on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor is not contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{what}: dtype {t.dtype}, the kernel takes "
                            f"{dtype}")


def ptr(t) -> int:
    """Device address of ``t`` for a ``c_void_p`` argument (0 for None)."""
    return 0 if t is None else t.data_ptr()
