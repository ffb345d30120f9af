"""The port's isomorphism mode against the reference package on the
CPU, on SR(16,6,2,2): the 4x4 rook's graph and the Shrikhande graph
(``write_sr16622``).  1-WL cannot tell them apart; the rook's graph has
K4s and the Shrikhande graph has none, so GSN with edge-level counts of
K3 and K4 (``--id_type complete_graph --k 4``) can.

Embeddings from the reference's ``init`` carried through the weight
bridge must match at the forward tolerances (rtol 2e-4 / atol 2e-5); the
verdicts through the port's CLI must be the published ones: failure 0%
for GSN, 100% for the MPNN.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest

from gsn_tpu.config import GSNConfig as JaxConfig
from gsn_tpu.graphs.container import batch_graphs as jax_batch_graphs
from gsn_tpu.graphs.container import pad_cap
from gsn_tpu.nn.models import build_model as jax_build_model
from gsn_tpu.train import isomorphism as jax_iso
from gsn_tpu_torch import cli
from gsn_tpu_torch.data.synthetic import write_sr16622
from gsn_tpu_torch.nn.models import build_model
from gsn_tpu_torch.params import load_flax_variables
from gsn_tpu_torch.train import isomorphism

FWD = dict(rtol=2e-4, atol=2e-5)
MODELS = ("GSN_sparse", "MPNN_sparse")


def sr_argv(root, model_name):
    """README.md's SR command on sr16622, with K3/K4 edge counts."""
    return ["--seed", "0", "--dataset", "SR_graphs",
            "--dataset_name", "sr16622", "--root_folder", root,
            "--cache_folder", root + "/cache", "--id_type", "complete_graph",
            "--k", "4", "--id_scope", "local",
            "--id_embedding", "one_hot_encoder", "--model_name", model_name,
            "--num_layers", "2", "--d_out", "16", "--msg_kind", "general",
            "--bn", "False", "--readout", "sum", "--final_projection",
            "False", "--jk_mlp", "True", "--mode", "isomorphism_test",
            "--wandb", "False", "--device", "cpu"]


@pytest.fixture(scope="module")
def sr(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sr"))
    write_sr16622(root)
    return root


def prepared(root, model_name):
    args = vars(cli.build_parser().parse_args(sr_argv(root, model_name)))
    return cli.prepare(args)


@pytest.mark.parametrize("model_name", MODELS)
def test_embeddings_match_reference(sr, model_name):
    graphs, cfg = prepared(sr, model_name)
    assert len(graphs) == 2
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})
    want = jax_iso.embed_graphs(copy.deepcopy(graphs), jcfg, seed=0)
    # the reference's init, as embed_graphs makes it
    node_cap = pad_cap(sum(g["x"].shape[0] for g in graphs))
    edge_cap = pad_cap(sum(g["edge_index"].shape[1] for g in graphs))
    first = jax_batch_graphs(copy.deepcopy(graphs), node_cap, edge_cap,
                             pad_cap(16, 8))
    variables = jax_build_model(jcfg.finalize()).init(
        jax.random.PRNGKey(0), first, train=False)
    model = build_model(cfg)
    load_flax_variables(
        model, jax.tree_util.tree_map(np.asarray, dict(variables["params"])),
        jax.tree_util.tree_map(np.asarray,
                               dict(variables.get("batch_stats", {}))))
    got = isomorphism.embed(model, graphs, device="cpu")
    np.testing.assert_allclose(got, want, **FWD)


@pytest.mark.parametrize("model_name,failure", [("GSN_sparse", 0.0),
                                                ("MPNN_sparse", 1.0)])
def test_cli_verdicts(sr, model_name, failure, capsys):
    out = cli.main(vars(cli.build_parser().parse_args(
        sr_argv(sr, model_name))))
    assert out == {"failure_percentage": failure, "pairs": 1,
                   "fails": int(failure)}
    assert f"Failure Percentage: {100 * failure:.2f}%" in \
        capsys.readouterr().out
    graphs, cfg = prepared(sr, model_name)
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})
    assert jax_iso.run_isomorphism_test(graphs, jcfg)[2] == failure
