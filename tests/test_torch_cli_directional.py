"""The port's directional CLI (``gsn_tpu_torch.cli_directional``) against
the reference's (``gsn_tpu.cli_directional``) on the CPU: the flag
surface on scripts/dgn_molhiv_10_runs.py's published flag set, the JSON
config merge, and ``main`` on a small molhiv-like set written by
``write_molhiv_dataset``, both packages from the same initial weights
(carried by ``params.py``) with dropout 0: the best-val epoch equal and
its ROCs at the f32 tolerances (rtol 2e-4 / atol 2e-5); then the port's
``--parallel dp`` with one gloo rank against its serial run.

The reference runs with ``--use_mxu False`` (its plain f32 layout): its
slab layout's one-hot products split f32 into bf16 passes
(tests/test_torch_dgn.py's slab tolerances), which is not what the
published-result comparison holds.
"""

import json
import os
import shlex

import numpy as np
import pytest

from gsn_tpu import cli_directional as jax_cli
from gsn_tpu.train import loop as jax_loop
from gsn_tpu_torch import cli_directional as cli
from gsn_tpu_torch.data.synthetic import write_molhiv_dataset
from gsn_tpu_torch.params import load_flax_variables
from gsn_tpu_torch.train import loop

# scripts/dgn_molhiv_10_runs.py's flags, verbatim (seed 1, 200 epochs)
DGN_MOLHIV = (
    "--weight_decay 3e-6 --L 4 --type_net simple --hidden_dim 60 "
    "--out_dim 60 --residual True --edge_feat False --readout mean "
    "--in_feat_dropout 0.0 --dropout 0.3 --graph_norm False "
    "--batch_norm True --aggregators 'mean max min dir0-av dir1-av "
    "dir2-av dir3-av' --scalers identity --dataset ogbg-molhiv "
    "--epochs 200 --init_lr 0.01 --lr_reduce_factor 0.5 "
    "--lr_schedule_patience 20 --min_lr 0.0001 --id_scope local --k 6 "
    "--id_type cycle_graph --directions subgraphs --data_root <root> "
    "--device default --use_mxu True --seed 1")

ARGV_LINES = {
    "defaults": "",
    "dgn_molhiv_10_runs": DGN_MOLHIV,
    "options": ("--config cfg.json --compute_dtype bfloat16 --dropout_rng "
                "rbg --parallel dp --parallel_devices 2 --device cpu "
                "--k 4,5 --induced True --pos_enc_dim 2 --norm sym "
                "--directions 'eig subgraphs' --max_time 0.5"),
}


@pytest.mark.parametrize("name", sorted(ARGV_LINES))
def test_build_parser_matches_reference(name):
    argv = shlex.split(ARGV_LINES[name])
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(jax_cli.build_parser().parse_args(argv))
    assert got == want


def test_build_parser_has_the_same_flags():
    """Every flag with the same destination, default, type (by name) and
    choices."""
    def flags(parser):
        return {a.option_strings[0]: (a.dest, a.default,
                                      getattr(a.type, "__name__", None),
                                      a.choices)
                for a in parser._actions if a.dest != "help"}
    assert flags(cli.build_parser()) == flags(jax_cli.build_parser())


def test_load_config_json_and_explicit_flags(tmp_path):
    """The JSON file beats the parser's defaults, typed flags beat the
    file, and a plain dict counts as all-explicit; as the reference's."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({
        "params": {"epochs": 7, "init_lr": 0.123, "not_a_flag": 1},
        "net_params": {"aggregators": "mean max", "hidden_dim": 33}}))
    argv = ["--config", str(path), "--hidden_dim", "44"]
    for mod in (cli, jax_cli):
        parser = mod.build_parser()
        explicit = mod._explicit_flags(parser, argv)
        assert explicit == {"config", "hidden_dim"}
        args = mod.load_config(vars(parser.parse_args(argv)), explicit)
        assert (args["epochs"], args["init_lr"], args["aggregators"],
                args["hidden_dim"]) == (7, 0.123, "mean max", 44)
        assert "not_a_flag" not in args
        prog = mod.load_config({"config": str(path), "epochs": 200,
                                "hidden_dim": None})
        assert (prog["epochs"], prog["hidden_dim"]) == (200, 33)
    # no file: the arguments as given
    args = vars(cli.build_parser().parse_args(["--config", "missing.json"]))
    assert cli.load_config(dict(args)) == args


def small_flags(root, cache, *extra):
    """The published flags at a small size: 2 layers of 16, batch 16, 3
    epochs, dropout 0, on the CPU, counting in this process."""
    argv = shlex.split(DGN_MOLHIV.replace("<root>", root))
    argv += ["--cache_folder", cache, "--device", "cpu", "--L", "2",
             "--hidden_dim", "16", "--out_dim", "16", "--batch_size", "16",
             "--epochs", "3", "--dropout", "0.0", "--multiprocessing",
             "False", "--print_epoch_interval", "1"]
    return argv + list(extra)


@pytest.fixture(scope="module")
def molhiv_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dgn") / "ogb")
    write_molhiv_dataset(root, num_graphs=120, seed=3)
    return root


def test_main_matches_reference(molhiv_root, monkeypatch, tmp_path):
    """``main`` of both packages from the reference's initial weights:
    the best-val epoch equal, its val and test ROC at the f32
    tolerances, and each epoch's train loss within rtol 1e-3."""
    init = {}
    real_init = jax_loop.Trainer.init_state

    def keep(self, *a, **k):
        state = real_init(self, *a, **k)
        init["params"], init["batch_stats"] = state.params, \
            state.batch_stats
        return state

    monkeypatch.setattr(jax_loop.Trainer, "init_state", keep)
    ref_hist = []
    real_epoch = jax_loop.Trainer.train_epoch

    def record(self, *a, **k):
        out = real_epoch(self, *a, **k)
        ref_hist.append(float(out[1]))
        return out

    monkeypatch.setattr(jax_loop.Trainer, "train_epoch", record)
    want = jax_cli.main(vars(jax_cli.build_parser().parse_args(
        small_flags(molhiv_root, str(tmp_path / "jcache"), "--use_mxu",
                    "False"))))

    import jax
    import flax

    def numpy_tree(tree):
        return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))

    real_port_init = loop.Trainer.init_state

    def carried(self, seed=0):
        state = real_port_init(self, seed)
        load_flax_variables(state.model, numpy_tree(init["params"]),
                            numpy_tree(init["batch_stats"]))
        return state

    monkeypatch.setattr(loop.Trainer, "init_state", carried)
    hist = []
    got = cli.main(vars(cli.build_parser().parse_args(
        small_flags(molhiv_root, str(tmp_path / "tcache")))), history=hist)
    assert got is not None and want is not None
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1:], want[1:], rtol=2e-4, atol=2e-5)
    assert len(hist) == len(ref_hist) == 3
    np.testing.assert_allclose([h["train_loss"] for h in hist], ref_hist,
                               rtol=1e-3)
    assert all(np.isfinite([h["val_roc"], h["test_roc"]]).all()
               for h in hist)


def test_parallel_dp_one_rank_matches_serial(molhiv_root, tmp_path):
    """``--parallel dp --parallel_devices 1`` (one spawned gloo rank, BN
    over the dp axis) gives the serial run's epochs."""
    serial, par = [], []
    best_s = cli.main(vars(cli.build_parser().parse_args(small_flags(
        molhiv_root, str(tmp_path / "c1"), "--epochs", "2"))),
        history=serial)
    best_p = cli.main(vars(cli.build_parser().parse_args(small_flags(
        molhiv_root, str(tmp_path / "c2"), "--epochs", "2", "--parallel",
        "dp", "--parallel_devices", "1"))), history=par)
    assert best_p[0] == best_s[0]
    np.testing.assert_allclose(best_p[1:], best_s[1:], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose([h["train_loss"] for h in par],
                               [h["train_loss"] for h in serial], rtol=1e-5)


def test_main_without_a_card_raises(molhiv_root, monkeypatch):
    """The default device is the card: with none, main raises before it
    reads the data."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = vars(cli.build_parser().parse_args(
        ["--data_root", os.path.join(molhiv_root, "missing")]))
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(args)
