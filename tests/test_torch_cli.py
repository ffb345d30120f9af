"""The port's CLI (``gsn_tpu_torch.cli``) and its data path against
the reference package on the CPU: the flag surface, the pattern
vocabulary, the loaders, splits and dataset cache (each package reads
the other's), and the CLI's train -> checkpoint -> test and resume
round trips with ``--device cpu``.  Fixtures are written by the tests:
the TU toy set of tests/test_cli.py, the ZINC pickles of
tests/test_zinc_pipeline.py and of ``write_zinc_dataset``, and a small
OGB csv.gz set.
"""

import gzip
import json
import os
import shlex
import shutil

import jax
import numpy as np
import pytest
import torch

from gsn_tpu import cli as jax_cli
from gsn_tpu.config import GSNConfig as JaxConfig
from gsn_tpu.data import loaders as jax_loaders
from gsn_tpu.data import pipeline as jax_pipeline
from gsn_tpu.data import splits as jax_splits
from gsn_tpu.graphs import patterns as jax_patterns
from gsn_tpu.graphs.batching import iterate_batches as jax_batches
from gsn_tpu.nn.models import build_model as jax_build_model
from gsn_tpu.train.logging import RunLogger as JaxRunLogger
from gsn_tpu_torch import cli
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data import loaders, pipeline, splits
from gsn_tpu_torch.data.synthetic import make_zinc_like, write_zinc_dataset
from gsn_tpu_torch.graphs import patterns
from gsn_tpu_torch.nn.models import build_model
from gsn_tpu_torch.train.logging import RunLogger
from test_cli import make_tu_dataset
from test_zinc_pipeline import make_zinc_fixture

# scripts/zinc_10_runs.py --budget 500K, seed 0 (its argv, as built there)
ZINC_500K = (
    "--seed 0 --onesplit True --dataset chemical --dataset_name ZINC "
    "--root_folder ./datasets --id_type cycle_graph --induced False --k 8 "
    "--id_scope global --id_encoding one_hot_unique "
    "--id_embedding one_hot_encoder --input_node_encoder one_hot_encoder "
    "--edge_encoder one_hot_encoder --model_name GSN_edge_sparse "
    "--msg_kind general --num_layers 4 --d_out 150 --dropout_features 0 "
    "--final_projection False --jk_mlp True --readout sum "
    "--batch_size 128 --num_epochs 1000 --lr 1e-3 "
    "--scheduler ReduceLROnPlateau --decay_rate 0.5 --patience 5 "
    "--min_lr 1e-5 --regression True --loss_fn L1Loss "
    "--prediction_fn L1Loss --mode train --return_scores")

ARGV_LINES = {
    "defaults": "",
    # README.md's commands
    "readme_sr251256": (
        "--seed 0 --dataset SR_graphs --dataset_name sr251256 "
        "--root_folder <datasets> --id_type cycle_graph --induced True "
        "--k 6 --id_scope local --id_embedding one_hot_encoder "
        "--model_name GSN_sparse --num_layers 2 --d_out 64 "
        "--msg_kind general --bn False --readout sum "
        "--final_projection False --jk_mlp True --mode isomorphism_test"),
    "readme_imdb": (
        "--seed 0 --dataset social --dataset_name IMDBBINARY "
        "--root_folder <datasets> --id_type complete_graph --induced False "
        "--k 5 --id_scope local --id_encoding one_hot_unique "
        "--id_embedding one_hot_encoder --model_name GSN_sparse "
        "--msg_kind gin --num_layers 4 --d_out 64 --final_projection True "
        "--readout mean --batch_size 32 --num_epochs 300 --num_iters 50 "
        "--lr 1e-3 --decay_steps 10 --decay_rate 0.5 --mode train"),
    "readme_multiprocess": ("--coordinator_address host0:9955 "
                            "--num_procs_distributed 4 --process_id 2"),
    "zinc_10_runs_500K": ZINC_500K,
    "lists_and_custom": (
        "--fold_idx 0,3 --k 3,4,5 --final_projection True,False,True "
        "--id_type custom --custom_edge_list 0,1,,1,2,,,0,1,,1,2,,2,0 "
        "--id_bins 2,3 --degree_range 0,5"),
    "precision_layout_devices": (
        "--compute_dtype bfloat16 --use_mxu True --caps_mode tight "
        "--device cpu --device_idx 1 --dropout_rng rbg --parallel ep "
        "--parallel_devices 4 --wandb False --resume True"),
    "ogb_molhiv": (
        "--dataset ogb --dataset_name ogbg-molhiv --features_scope simple "
        "--vn True --d_out_vn 300 --input_node_encoder atom_encoder "
        "--edge_encoder bond_encoder --model_name GSN_edge_sparse_ogb "
        "--msg_kind ogb --train_eps True --residual True --loss_fn "
        "BCEWithLogitsLoss --prediction_fn None --scheduler None"),
}


@pytest.mark.parametrize("name", sorted(ARGV_LINES))
def test_build_parser_matches_reference(name):
    argv = shlex.split(ARGV_LINES[name])
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(jax_cli.build_parser().parse_args(argv))
    assert got == want


def test_build_parser_has_the_same_flags():
    """Every flag with the same default, type (the parsers are the
    port's copies, so by name) and choices."""
    def flags(parser):
        return {a.option_strings[0]: (a.dest, a.default,
                                      getattr(a.type, "__name__", None),
                                      a.choices)
                for a in parser._actions if a.dest != "help"}
    assert flags(cli.build_parser()) == flags(jax_cli.build_parser())


# ---- the pattern vocabulary ------------------------------------------------

VOCAB = [("cycle_graph", [6]), ("path_graph", [5]), ("complete_graph", [5]),
         ("star_graph", [4]), ("binomial_tree", [3]),
         ("nonisomorphic_trees", [6]), ("cycle_graph_chosen_k", [4, 6]),
         ("nonisomorphic_trees_chosen_k", [5]), ("diamond_graph", [4])]


@pytest.mark.parametrize("id_type,k", VOCAB)
def test_pattern_vocabulary_matches_reference(id_type, k):
    got = patterns.resolve_pattern_vocabulary(id_type, k)
    assert got == jax_patterns.resolve_pattern_vocabulary(id_type, k)
    for edges in got:
        n = 1 + max(max(e) for e in edges)
        line = patterns.write_graph6(n, edges)
        assert line == jax_patterns.write_graph6(n, edges)
        back_n, back = patterns.parse_graph6(line)
        assert back_n == n
        assert sorted(back) == sorted((min(e), max(e)) for e in edges)


def test_custom_and_g6_vocabularies_match_reference(tmp_path):
    custom = [[(0, 1), (1, 2)], [(0, 1), (1, 2), (2, 0)]]
    assert patterns.resolve_pattern_vocabulary("custom", [3],
                                               custom_edge_list=custom) \
        == custom
    folder = tmp_path / "all_simple_graphs"
    folder.mkdir()
    for k in (3, 4):
        graphs = [(k, e) for e in (patterns.path_graph(k),
                                   patterns.complete_graph(k))]
        (folder / f"graph{k}c.g6").write_text(
            "".join(patterns.write_graph6(n, e) + "\n" for n, e in graphs))
    for id_type, k in (("all_simple_graphs", [4]),
                       ("all_simple_graphs_chosen_k", [4])):
        got = patterns.resolve_pattern_vocabulary(id_type, k,
                                                  root_folder=str(tmp_path))
        assert got == jax_patterns.resolve_pattern_vocabulary(
            id_type, k, root_folder=str(tmp_path))
        assert got
    with pytest.raises(NotImplementedError):
        patterns.resolve_pattern_vocabulary("no_such_family", [3])


# ---- loaders and splits ------------------------------------------------------

def assert_graphs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            if isinstance(a[key], np.ndarray) or np.isscalar(a[key]):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
                assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype
            else:
                assert a[key] == b[key], key


def write_ogb_fixture(root, num_graphs=6, seed=0):
    """An ogbg-molhiv-shaped raw csv.gz set under <root>/ogb/ogbg-molhiv."""
    rng = np.random.RandomState(seed)
    raw = os.path.join(root, "ogb", "ogbg-molhiv", "ogbg_molhiv", "raw")
    os.makedirs(raw)
    nodes, edges, efeat, nfeat, n_list, e_list = [], [], [], [], [], []
    for _ in range(num_graphs):
        n = rng.randint(3, 8)
        e = [(i, i + 1) for i in range(n - 1)]
        n_list.append(n)
        e_list.append(len(e))
        edges += e
        efeat += [rng.randint(0, 3, 3) for _ in e]
        nfeat += [rng.randint(0, 5, 9) for _ in range(n)]
    labels = rng.randint(0, 2, (num_graphs, 1))

    def write(name, rows):
        with gzip.open(os.path.join(raw, name), "wt") as f:
            for r in rows:
                f.write(",".join(map(str, np.atleast_1d(r))) + "\n")

    write("edge.csv.gz", edges)
    write("edge-feat.csv.gz", efeat)
    write("node-feat.csv.gz", nfeat)
    write("num-node-list.csv.gz", n_list)
    write("num-edge-list.csv.gz", e_list)
    write("graph-label.csv.gz", labels)
    return os.path.join(root, "ogb", "ogbg-molhiv")


def test_loaders_match_reference(tmp_path):
    tu = make_tu_dataset(str(tmp_path))
    for degree_as_tag in (False, True):
        got, n_got = loaders.load_tu_data(tu, "TOY", degree_as_tag)
        want, n_want = jax_loaders.load_tu_data(tu, "TOY", degree_as_tag)
        assert n_got == n_want
        assert_graphs_equal(got, want)
    for zinc in (make_zinc_fixture(str(tmp_path / "z1")),
                 write_zinc_dataset(str(tmp_path / "z2"), (9, 4, 5), seed=1)):
        got, want = loaders.load_zinc_data(zinc), \
            jax_loaders.load_zinc_data(zinc)
        assert got[1:] == want[1:]
        assert_graphs_equal(got[0], want[0])
    ogb = write_ogb_fixture(str(tmp_path))
    got, want = loaders.load_ogb_data(ogb, "ogbg-molhiv"), \
        jax_loaders.load_ogb_data(ogb, "ogbg-molhiv")
    assert got[1] == want[1]
    assert_graphs_equal(got[0], want[0])
    sr = tmp_path / "sr"
    sr.mkdir()
    (sr / "toy.g6").write_text("".join(
        patterns.write_graph6(n, e) + "\n"
        for n, e in ((5, patterns.cycle_graph(5)), (4, patterns.star_graph(3)))))
    got, want = loaders.load_g6_graphs(str(sr), "toy"), \
        jax_loaders.load_g6_graphs(str(sr), "toy")
    assert got[1] == want[1]
    assert_graphs_equal(got[0], want[0])


def test_splits_match_reference(tmp_path):
    labels = np.random.RandomState(2).randint(0, 3, 57)
    graphs = [{"y": np.int64(v), "i": i} for i, v in enumerate(labels)]
    for seed in (0, 4):
        for fold in (0, 5, 9):
            got = splits.separate_data(graphs, seed, fold)
            want = jax_splits.separate_data(graphs, seed, fold)
            assert [[g["i"] for g in part] for part in got] \
                == [[g["i"] for g in part] for part in want]
    zinc = write_zinc_dataset(str(tmp_path), (7, 3, 4))
    graphs = [{"i": i} for i in range(14)]
    got = splits.separate_data_given_split(graphs, zinc, -1)
    want = jax_splits.separate_data_given_split(graphs, zinc, -1)
    assert [[g["i"] for g in part] for part in got] \
        == [[g["i"] for g in part] for part in want] \
        == [list(range(7)), list(range(10, 14)), list(range(7, 10))]
    tu = make_tu_dataset(str(tmp_path))
    tr, te, val = splits.separate_data_given_split(list(range(24)), tu, 0)
    assert val is None and len(tr) + len(te) == 24


# ---- prepare_dataset and its cache --------------------------------------------

DATASETS = {
    # name: (fixture writer, dataset, name, id_scope, id_type, k)
    "tu": (make_tu_dataset, "social", "TOY", "local", "cycle_graph", 5),
    "zinc": (make_zinc_fixture, "chemical", "ZINC", "global",
             "cycle_graph", 6),
}


def _prepare(module, root, which, k, cache):
    _w, dataset, name, scope, id_type, _k = DATASETS[which]
    path = os.path.join(root, dataset, name)
    return module.prepare_dataset(path, dataset, name, id_scope=scope,
                                  id_type=id_type, k=[k], root_folder=root,
                                  cache_root=cache)


def assert_prepared_equal(got, want):
    assert got[1] == want[1] and got[2] == want[2]
    assert_graphs_equal(got[0], want[0])


@pytest.mark.parametrize("which", sorted(DATASETS))
def test_prepare_dataset_matches_and_caches_cross_read(which, tmp_path):
    writer, _d, _n, _s, _t, k = DATASETS[which]
    root = str(tmp_path / "data")
    writer(root)
    ours = _prepare(pipeline, root, which, k, str(tmp_path / "c_ours"))
    ref = _prepare(jax_pipeline, root, which, k, str(tmp_path / "c_ref"))
    assert_prepared_equal(ours, ref)
    # each package reads the other's cache: the raw data is gone
    shutil.rmtree(root)
    os.makedirs(root)
    assert_prepared_equal(
        _prepare(jax_pipeline, root, which, k, str(tmp_path / "c_ours")), ref)
    assert_prepared_equal(
        _prepare(pipeline, root, which, k, str(tmp_path / "c_ref")), ref)
    # k-downgrade: a smaller k is sliced from either package's cache and
    # equals a fresh count at that k
    writer(str(tmp_path / "fresh"))
    fresh = _prepare(jax_pipeline, str(tmp_path / "fresh"), which, k - 2,
                     str(tmp_path / "c_fresh"))
    assert_prepared_equal(
        _prepare(pipeline, root, which, k - 2, str(tmp_path / "c_ref")),
        fresh)
    assert_prepared_equal(
        _prepare(jax_pipeline, root, which, k - 2, str(tmp_path / "c_ours")),
        fresh)
    got, sizes = pipeline.downgrade_k(ref[0], k - 1, ref[2], 3)
    want, want_sizes = jax_pipeline.downgrade_k(ref[0], k - 1, ref[2], 3)
    assert sizes == want_sizes
    assert_graphs_equal(got, want)


# ---- the CLI ----------------------------------------------------------------

def tu_argv(tmp_path, *extra):
    return [
        "--dataset", "social", "--dataset_name", "TOY",
        "--root_folder", str(tmp_path), "--cache_folder",
        str(tmp_path / "cache"), "--id_type", "cycle_graph", "--k", "4",
        "--id_scope", "global", "--model_name", "GSN_sparse",
        "--num_layers", "2", "--d_out", "16", "--msg_kind", "general",
        "--batch_size", "8", "--fold_idx", "0", "--num_epochs", "8",
        "--eval_frequency", "7", "--lr", "0.01", "--scheduler", "None",
        "--wandb", "False", "--device", "cpu", *extra]


def run(argv):
    return cli.main(vars(cli.build_parser().parse_args(argv)))


def test_cli_train_checkpoint_test_round_trip(tmp_path):
    make_tu_dataset(str(tmp_path))
    results = run(tu_argv(tmp_path))
    hist = results[0]
    assert len(hist["test_accs"]) == 2 and not hist["val_losses"]
    assert all(np.isfinite(hist[k]).all() for k in hist if hist[k])
    run_dir = tmp_path / "cache" / "results" / "temp" / "0" / "GSN_sparse"
    assert (run_dir / "checkpoints" / "checkpoint.pt").exists()
    assert json.loads((run_dir / "params.json").read_text())["device"] \
        == "cpu"
    recs = [json.loads(li) for li in
            (run_dir / "log.jsonl").read_text().splitlines()]
    assert [r.get("step") for r in recs if "test_acc" in r] == [0, 7]
    assert {"epoch_s", "host_batch_s", "step_median_s", "eval_s"} \
        <= set(recs[-2])
    tested = run(tu_argv(tmp_path, "--mode", "test"))
    assert tested[0]["test_acc"] == hist["test_accs"][-1]
    assert tested[0]["test_loss"] == hist["test_losses"][-1]


def zinc_argv(root, *extra):
    argv = shlex.split(ZINC_500K) + [
        "--root_folder", root, "--cache_folder", os.path.join(root, "cache"),
        "--num_layers", "2", "--d_out", "16", "--k", "6",
        "--num_epochs", "2", "--batch_size", "8", "--wandb", "False",
        "--device", "cpu", *extra]
    argv.remove("--return_scores")
    return argv


def test_cli_zinc_flags_train_with_val_and_resume(tmp_path):
    """The published ZINC flags at 2 layers and d=16: Plateau on the val
    split, then --resume continues at epoch 2 and matches an
    uninterrupted 3-epoch run bit for bit."""
    root = str(tmp_path)
    make_zinc_fixture(root)
    hist = run(zinc_argv(root))[0]
    assert len(hist["val_losses"]) == 2
    assert all(np.isfinite(hist[k]).all() for k in hist)
    resumed = run(zinc_argv(root, "--resume", "True", "--num_epochs", "3"))[0]
    assert len(resumed["val_losses"]) == 1
    straight = run(zinc_argv(root, "--num_epochs", "3",
                             "--results_folder", "straight"))[0]
    for key in resumed:
        assert resumed[key] == straight[key][2:], key


@pytest.mark.parametrize("flags,exc,match", [
    # env:// (no address, or "auto") without the variables it reads
    (("--coordinator_address", "auto", "--num_procs_distributed", "2",
      "--process_id", "0"), RuntimeError, "env:// and needs MASTER_ADDR"),
    (("--coordinator_address", "127.0.0.1:9955",
      "--num_procs_distributed", "2", "--process_id", "2"), ValueError,
     "process id 2 of 2 processes"),
    (("--coordinator_address", "127.0.0.1:9955"), ValueError,
     "needs the process count"),
    (("--coordinator_address", "127.0.0.1:9955", "--num_procs_distributed",
      "1", "--process_id", "0", "--mode", "isomorphism_test"), ValueError,
     "isomorphism_test runs on one device"),
])
def test_cli_multi_device_flags_raise(tmp_path, monkeypatch, flags, exc,
                                      match):
    """The multi-process flags raise, before any process group forms or
    any cache is written, on an ``env://`` rendezvous without its
    variables, a process id out of range, an address without the
    process count and id, and the isomorphism mode."""
    import torch.distributed as dist
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    make_tu_dataset(str(tmp_path))
    with pytest.raises(exc, match=match):
        run(tu_argv(tmp_path, *flags))
    assert not dist.is_initialized()
    assert not (tmp_path / "cache").exists()


@pytest.mark.parametrize("mode", ["default", "ep"])
def test_cli_multi_process_runs(tmp_path, capsys, mode):
    """One process joining a coordinator (a gloo group of 1): without
    ``--parallel`` it trains data-parallel and says so, with
    ``--parallel ep`` edge-partitioned; a finite history, one log and one
    checkpoint, and no group left when ``main`` returns.  (Two
    processes: tests/test_torch_distributed.py.)"""
    import socket

    import torch.distributed as dist
    make_tu_dataset(str(tmp_path))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    extra = ("--parallel", "ep") if mode == "ep" else ()
    hist = run(tu_argv(tmp_path, *extra, "--coordinator_address",
                       f"127.0.0.1:{port}", "--num_procs_distributed", "1",
                       "--process_id", "0"))[0]
    assert not dist.is_initialized()
    assert len(hist["test_accs"]) == 2
    assert all(np.isfinite(hist[k]).all() for k in hist if hist[k])
    said = "defaulting --parallel to 'dp'" in capsys.readouterr().out
    assert said == (mode == "default")
    run_dir = tmp_path / "cache" / "results" / "temp" / "0" / "GSN_sparse"
    assert sorted(os.listdir(run_dir / "checkpoints")) == ["checkpoint.pt"]
    recs = (run_dir / "log.jsonl").read_text().splitlines()
    assert sum('"train_loss"' in r for r in recs) == 2


def test_cli_runs_on_the_card_or_raises(tmp_path, monkeypatch):
    make_tu_dataset(str(tmp_path))
    argv = tu_argv(tmp_path)
    argv[argv.index("--device") + 1] = "default"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--device_idx 1"):
        run(argv + ["--device_idx", "1"])
    assert cli.select_device({"device": "default", "device_idx": 0}) \
        == torch.device("cuda:0")


def test_watch_total_equals_reference_census():
    graphs, d_id = make_zinc_like(8)
    kw = dict(model_name="GSN_edge_sparse", num_layers=3, d_out=24,
              out_features=1, id_scope="global", bn_mlp=True,
              id_embedding="one_hot_encoder",
              input_node_encoder="one_hot_encoder",
              edge_encoder="one_hot_encoder", final_projection=[False],
              jk_mlp=True, in_features=1, d_in_node_encoder=[28],
              d_in_edge_encoder=[4], d_in_id=d_id)
    example = next(jax_batches(graphs, 8, y_dtype=np.float32))
    params = jax_build_model(JaxConfig(**kw)).init(
        jax.random.PRNGKey(0), example, train=False)["params"]
    want = JaxRunLogger().watch(params)["num_params"]
    got = RunLogger().watch(build_model(GSNConfig(**kw)))
    assert got["num_params"] == want
    assert sum(v for k, v in got.items() if k != "num_params") == want
