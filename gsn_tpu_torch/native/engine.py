"""ctypes binding for the C++ VF2 counting engine.

Auto-compiles ``vf2_engine.cpp`` into ``build/_vf2_engine.so`` at the
repository root on first use (g++ -O3; plain C ABI).  The Python
oracle in ``gsn_tpu_torch.counting.vf2`` defines the semantics; this engine
must agree bit-for-bit on counts (tested in tests/test_torch_host.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "vf2_engine.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
_SO = os.path.join(_BUILD, "_vf2_engine.so")

_lib = None
_lock = threading.Lock()
_disabled = os.environ.get("GSN_TPU_DISABLE_NATIVE", "") == "1"

# callers fall back to the Python oracle above this host size (dense
# edge-row lookup is n^2)
MAX_DENSE_LOOKUP_NODES = 4096


def _build() -> bool:
    # build under a private name, then rename: concurrent test workers
    # must never load a half-written library
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
            "-o", tmp, _SRC]
    for cmd in (base + ["-fopenmp"], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, _SO)
            return True
        except Exception:
            continue
    return False


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.vf2_vertex_counts.restype = ctypes.c_int64
        lib.vf2_vertex_counts.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.c_int32, ctypes.c_int32, f64p]
        lib.vf2_edge_counts.restype = ctypes.c_int64
        lib.vf2_edge_counts.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int32, i32p,
            i32p, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.c_int64, i32p,
            ctypes.c_int32, ctypes.c_int32, f64p]
        lib.vf2_count_automorphisms.restype = ctypes.c_int64
        lib.vf2_count_automorphisms.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int32]
        lib.vf2_vertex_counts_dir.restype = ctypes.c_int64
        lib.vf2_vertex_counts_dir.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.c_int32, ctypes.c_int32, f64p]
        lib.vf2_edge_counts_dir.restype = ctypes.c_int64
        lib.vf2_edge_counts_dir.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int32, i32p,
            i32p, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.c_int64, i32p,
            ctypes.c_int32, ctypes.c_int32, f64p]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.vf2_vertex_counts_batch.restype = ctypes.c_int64
        lib.vf2_vertex_counts_batch.argtypes = [
            i32p, i64p, i32p, i64p, ctypes.c_int32,
            i32p, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            f64p, ctypes.c_int32]
        lib.vf2_edge_counts_batch.restype = ctypes.c_int64
        lib.vf2_edge_counts_batch.argtypes = [
            i32p, i64p, i32p, ctypes.c_int32,
            i32p, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.c_int64, i32p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, f64p, ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return not _disabled and _load() is not None


def _as_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def vertex_counts(edge_index: np.ndarray, pattern, induced: bool,
                  num_nodes: int) -> np.ndarray:
    lib = _load()
    pat_edges = _as_i32(np.array(pattern.edges).reshape(-1, 2))
    host_edges = _as_i32(edge_index.T)
    membership = _as_i32(np.array(pattern.orbit_membership))
    counts = np.zeros((num_nodes, pattern.num_orbits), dtype=np.float64)
    fn = (lib.vf2_vertex_counts_dir if pattern.directed
          else lib.vf2_vertex_counts)
    fn(_i32p(host_edges), host_edges.shape[0], num_nodes,
       _i32p(pat_edges), pat_edges.shape[0], pattern.num_vertices,
       _i32p(membership), pattern.num_orbits, int(induced),
       counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    counts /= pattern.aut_count
    return counts


def edge_counts(edge_index: np.ndarray, pattern, induced: bool,
                num_nodes: int) -> np.ndarray:
    lib = _load()
    host_edges = _as_i32(edge_index.T)
    num_rows = host_edges.shape[0]
    # dense (u, v) -> edge-row lookup; molecule/TU/SR graphs are tiny so
    # n^2 int32 is cheap (callers gate on MAX_DENSE_LOOKUP_NODES)
    lookup = np.full((num_nodes, num_nodes), -1, dtype=np.int32)
    lookup[host_edges[:, 0], host_edges[:, 1]] = np.arange(
        num_rows, dtype=np.int32)

    pat_edges = _as_i32(np.array(pattern.edges).reshape(-1, 2))
    dir_edges = _as_i32(np.array(pattern.directed_edges).reshape(-1, 2))
    membership = _as_i32(np.array(pattern.edge_orbit_membership))
    counts = np.zeros((num_rows, pattern.num_edge_orbits), dtype=np.float64)
    fn = (lib.vf2_edge_counts_dir if pattern.directed
          else lib.vf2_edge_counts)
    fn(_i32p(host_edges), num_rows, num_nodes, _i32p(lookup),
       _i32p(pat_edges), pat_edges.shape[0], pattern.num_vertices,
       _i32p(dir_edges), dir_edges.shape[0], _i32p(membership),
       pattern.num_edge_orbits, int(induced),
       counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    counts /= pattern.aut_count
    return counts


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _clamp_threads(n: int) -> int:
    """Oversubscription actively hurts the DFS inner loop; never ask for
    more OpenMP threads than physical cores."""
    return min(int(n), os.cpu_count() or 1) if n > 0 else 0


def _flatten_batch(edge_indices, num_nodes_list):
    num_graphs = len(edge_indices)
    ne = np.array([ei.shape[1] for ei in edge_indices], dtype=np.int64)
    edge_starts = np.zeros(num_graphs + 1, dtype=np.int64)
    np.cumsum(ne, out=edge_starts[1:])
    if edge_starts[-1]:
        edges_flat = _as_i32(np.concatenate(
            [ei.T for ei in edge_indices], axis=0))
    else:
        edges_flat = np.zeros((0, 2), dtype=np.int32)
    nn = _as_i32(np.asarray(num_nodes_list))
    node_starts = np.zeros(num_graphs + 1, dtype=np.int64)
    np.cumsum(nn.astype(np.int64), out=node_starts[1:])
    return edges_flat, edge_starts, nn, node_starts


def vertex_counts_batch(edge_indices, num_nodes_list, pattern,
                        induced: bool, num_threads: int = 0):
    """Per-graph [n_g, num_orbits] |Aut|-normalized counts for a list of
    graphs in one native call (OpenMP fan-out over graphs)."""
    lib = _load()
    edges_flat, edge_starts, nn, node_starts = _flatten_batch(
        edge_indices, num_nodes_list)
    pat_edges = _as_i32(np.array(pattern.edges).reshape(-1, 2))
    membership = _as_i32(np.array(pattern.orbit_membership))
    counts = np.zeros((int(node_starts[-1]), pattern.num_orbits),
                      dtype=np.float64)
    lib.vf2_vertex_counts_batch(
        _i32p(edges_flat), _i64p(edge_starts), _i32p(nn),
        _i64p(node_starts), len(edge_indices),
        _i32p(pat_edges), pat_edges.shape[0], pattern.num_vertices,
        _i32p(membership), pattern.num_orbits, int(induced),
        int(pattern.directed), _f64p(counts),
        _clamp_threads(num_threads))
    counts /= pattern.aut_count
    return [counts[node_starts[g]:node_starts[g + 1]]
            for g in range(len(edge_indices))]


def edge_counts_batch(edge_indices, num_nodes_list, pattern,
                      induced: bool, num_threads: int = 0):
    """Per-graph [e_g, num_edge_orbits] |Aut|-normalized counts."""
    lib = _load()
    edges_flat, edge_starts, nn, _ns = _flatten_batch(
        edge_indices, num_nodes_list)
    pat_edges = _as_i32(np.array(pattern.edges).reshape(-1, 2))
    dir_edges = _as_i32(np.array(pattern.directed_edges).reshape(-1, 2))
    membership = _as_i32(np.array(pattern.edge_orbit_membership))
    counts = np.zeros((int(edge_starts[-1]), pattern.num_edge_orbits),
                      dtype=np.float64)
    lib.vf2_edge_counts_batch(
        _i32p(edges_flat), _i64p(edge_starts), _i32p(nn),
        len(edge_indices),
        _i32p(pat_edges), pat_edges.shape[0], pattern.num_vertices,
        _i32p(dir_edges), dir_edges.shape[0], _i32p(membership),
        pattern.num_edge_orbits, int(induced), int(pattern.directed),
        _f64p(counts), _clamp_threads(num_threads))
    counts /= pattern.aut_count
    return [counts[edge_starts[g]:edge_starts[g + 1]]
            for g in range(len(edge_indices))]


def count_automorphisms(edges: np.ndarray, num_nodes: int) -> int:
    lib = _load()
    pat_edges = _as_i32(np.array(edges).reshape(-1, 2))
    return int(lib.vf2_count_automorphisms(
        _i32p(pat_edges), pat_edges.shape[0], num_nodes))
