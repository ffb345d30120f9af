"""The port's host code against the reference package, and the port's
independence from JAX.

``gsn_tpu_torch`` keeps its own copies of the numpy host code (counting,
encoding, batching); these must emit what the reference emits.  The
port's batcher builds its segment layout where the reference builds slab
metadata; the receiver-sorted edge order is the same, up to the tail
padding the slab layout adds.
"""

import ast
import copy
import os
import subprocess
import sys

import numpy as np
import pytest

from gsn_tpu.data.encoding import encode as jax_encode
from gsn_tpu.data.pipeline import generate_dataset as jax_generate
from gsn_tpu.graphs import batching as jax_batching
from gsn_tpu.graphs.container import batch_graphs as jax_batch_graphs
from gsn_tpu.graphs.patterns import cycle_graph as jax_cycle
from gsn_tpu_torch.counting import count_identifiers, counts
from gsn_tpu_torch.data.encoding import encode
from gsn_tpu_torch.data.pipeline import build_pattern_infos, generate_dataset
from gsn_tpu_torch.data.synthetic import (_molecule_graphs, make_molhiv_like,
                                          make_zinc_like)
from gsn_tpu_torch.graphs import batching
from gsn_tpu_torch.graphs.container import batch_graphs
from gsn_tpu_torch.graphs.patterns import cycle_graph
from gsn_tpu_torch.native import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gsn_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gsn_tpu")


def _graphs(num=24, seed=0):
    return _molecule_graphs(num, seed, [28], [4])


def _counted(scope, num=24, seed=0, induced=False):
    vocab_t = [cycle_graph(k) for k in range(3, 7)]
    vocab_j = [jax_cycle(k) for k in range(3, 7)]
    ours, sizes = generate_dataset(_graphs(num, seed), vocab_t,
                                   id_scope=scope, induced=induced)
    ref, ref_sizes = jax_generate(_graphs(num, seed), vocab_j,
                                  id_scope=scope, induced=induced)
    return ours, sizes, ref, ref_sizes


def _assert_counted_and_encoded_match(ours, sizes, ref, ref_sizes):
    assert sizes == ref_sizes
    for a, b in zip(ours, ref):
        for key in ("identifiers", "degrees", "edge_index"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["ids_on_edges"] == b["ids_on_edges"]
    ours, _e, d_id, _ed, _dd = encode(ours, "one_hot_unique")
    ref, _e, ref_d_id, _ed, _dd = jax_encode(ref, "one_hot_unique")
    assert d_id == ref_d_id
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["identifiers"], b["identifiers"])


@pytest.mark.parametrize("scope", ["global", "local"])
def test_generate_dataset_and_encode_match(scope):
    _assert_counted_and_encoded_match(*_counted(scope))


def test_generate_dataset_induced_local_matches():
    """Induced edge-level (local-scope) counts, the molhiv path's ids."""
    ours, sizes, ref, ref_sizes = _counted("local", induced=True)
    _assert_counted_and_encoded_match(ours, sizes, ref, ref_sizes)
    plain, *_ = _counted("local", induced=False)
    assert any((a["identifiers"] != b["identifiers"]).any()
               for a, b in zip(ours, plain))


@pytest.mark.parametrize("scope", ["global", "local"])
def test_native_engine_matches_python_oracle(scope, monkeypatch):
    """The copied C++ engine against the copied Python VF2 oracle."""
    if not engine.available():
        pytest.skip("g++ could not build the native counting engine")
    pats = build_pattern_infos([cycle_graph(k) for k in (3, 5, 6)], scope)
    graphs = _graphs(6, seed=3)
    native = [count_identifiers(g["edge_index"], pats, True,
                                g["x"].shape[0], scope) for g in graphs]
    monkeypatch.setattr(counts, "_native_engine", lambda: None)
    for g, got in zip(graphs, native):
        np.testing.assert_array_equal(
            got, count_identifiers(g["edge_index"], pats, True,
                                   g["x"].shape[0], scope))


def test_make_zinc_like_matches_reference_pipeline():
    graphs, d_id = make_zinc_like(16, seed=2)
    ref = _molecule_graphs(16, 2, [28], [4])
    ref, _ = jax_generate(ref, [jax_cycle(k) for k in range(3, 9)],
                          id_scope="global")
    ref, _e, ref_d_id, _ed, _dd = jax_encode(ref, "one_hot_unique")
    assert d_id == ref_d_id
    for a, b in zip(graphs, ref):
        np.testing.assert_array_equal(a["identifiers"], b["identifiers"])
        np.testing.assert_array_equal(a["x"], b["x"])


def test_make_molhiv_like_matches_reference_pipeline():
    graphs, d_id = make_molhiv_like(16, seed=2)
    atoms, bonds = [119, 4, 12, 12, 10, 6, 6, 2, 2], [5, 6, 2]
    ref = _molecule_graphs(16, 2, atoms, bonds)
    ref, _ = jax_generate(ref, [jax_cycle(k) for k in (3, 4, 5, 6)],
                          id_scope="local", induced=True)
    ref, _e, ref_d_id, _ed, _dd = jax_encode(ref, "one_hot_unique")
    assert d_id == ref_d_id
    for a, b in zip(graphs, ref):
        assert a["ids_on_edges"] and b["ids_on_edges"]
        for key in ("x", "edge_index", "edge_features", "identifiers",
                    "degrees", "y"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("scope,flow", [("global", "source_to_target"),
                                        ("local", "source_to_target"),
                                        ("global", "target_to_source")])
def test_batch_graphs_matches_reference(scope, flow):
    """Same node arrays, ids and receiver-sorted edge order as the
    reference's slab-layout batch (up to its tail padding), and a
    segment layout consistent with that order."""
    ours, _s, ref, _rs = _counted(scope, num=30, seed=1)
    ours, *_ = encode(ours, "one_hot_unique")
    ref, *_ = jax_encode(ref, "one_hot_unique")
    caps = (1024, 2048, 256)
    b = batch_graphs(ours, *caps, y_dtype=np.float32, flow=flow)
    r = jax_batch_graphs(ref, *caps, y_dtype=np.float32,
                         mxu_layout={"mode": "slab", "flow": flow,
                                     "block_n": 128, "block_e": 256})
    assert r.seg_mode == "slab"
    for key in ("x", "batch", "y", "node_mask", "graph_mask", "degrees"):
        np.testing.assert_array_equal(getattr(b, key), getattr(r, key),
                                      err_msg=key)
    E = b.num_real_edges
    assert E == int(r.edge_mask.sum())
    np.testing.assert_array_equal(b.edge_index[:, :E], r.edge_index[:, :E])
    np.testing.assert_array_equal(b.edge_features[:E], r.edge_features[:E])
    id_rows = E if scope == "local" else b.num_node_slots
    np.testing.assert_array_equal(b.identifiers[:id_rows],
                                  r.identifiers[:id_rows])
    np.testing.assert_array_equal(b.in_degree, r.seg_in_degree)
    assert not b.edge_mask[E:].any() and b.edge_mask[:E].all()

    recv = b.edge_index[b.select, :E]
    send = b.edge_index[1 - b.select, :E]
    np.testing.assert_array_equal(
        np.repeat(np.arange(b.num_node_slots), np.diff(b.recv_ptr)), recv)
    # send_perm: the real edges' sender order, then the padding slots'
    # own positions (every slot a valid row id; shapes are the caps')
    perm = b.send_perm[:E]
    np.testing.assert_array_equal(send[perm], np.sort(send))
    np.testing.assert_array_equal(b.send_perm[E:],
                                  np.arange(E, b.num_edge_slots))
    np.testing.assert_array_equal(
        np.repeat(np.arange(b.num_node_slots), np.diff(b.send_ptr)),
        send[perm])
    np.testing.assert_array_equal(
        np.repeat(np.arange(caps[2]), np.diff(b.graph_ptr)),
        b.batch[b.node_mask])
    np.testing.assert_array_equal(np.diff(b.graph_ptr), r.pool_counts)


def test_batching_policies_match_reference():
    graphs = _graphs(40)
    for g in graphs:
        g["degrees"] = np.zeros(g["x"].shape[0], np.float32)
    order = np.random.RandomState(0).permutation(len(graphs))
    assert (batching.tight_epoch_caps(order, graphs, 16)
            == jax_batching.tight_epoch_caps(order, graphs, 16))
    assert (batching.epoch_caps(graphs, 16)
            == jax_batching.epoch_caps(graphs, 16))
    assert (batching.infer_y_spec(graphs)
            == jax_batching.infer_y_spec(graphs))
    ours = list(batching.iterate_batches(
        copy.deepcopy(graphs), 16, shuffle=True,
        rng=np.random.RandomState(4)))
    ref = list(jax_batching.iterate_batches(
        graphs, 16, shuffle=True, rng=np.random.RandomState(4)))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.graph_mask, b.graph_mask)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_imports_no_jax_or_reference_package():
    bad = []
    for path in _port_sources():
        for mod in _imports(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    for script in ("chip_smoke.py", "kernel_turns.py"):
        for mod in _imports(os.path.join(REPO, script)):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{script}: {mod}")
    assert not bad, bad


def test_import_scan_covers_the_parallel_package():
    """The scan above reads every module of ``gsn_tpu_torch/parallel``."""
    scanned = {os.path.relpath(p, PKG) for p in _port_sources()}
    want = {os.path.join("parallel", f) for f in (
        "__init__.py", "collectives.py", "mesh.py", "dp.py", "ep.py",
        "trainer.py", "distributed.py", "edge_partition.py")}
    assert want <= scanned, want - scanned


def test_import_scan_covers_the_directional_cli_and_timing():
    """The scan reads the directional CLI and the timing and profiling
    modules too."""
    scanned = {os.path.relpath(p, PKG) for p in _port_sources()}
    want = {"cli_directional.py", "timing.py",
            os.path.join("train", "profiling.py")}
    assert want <= scanned, want - scanned


def test_port_imports_with_jax_poisoned():
    """Every module of the port imports with jax, flax, optax and
    gsn_tpu made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "import gsn_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    gsn_tpu_torch.__path__, 'gsn_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert len(names) >= 20
    assert {"gsn_tpu_torch.parallel.distributed",
            "gsn_tpu_torch.parallel.edge_partition"} <= set(names)
