"""The port's molhiv slice against the reference package on the CPU: B4
(``graph_broadcast``), the ``ogb`` message kind of ``GSNLayer``, the bond
encoder, ``GNN_OGB`` with the virtual node through the weight bridge on
both of the reference's layouts, the trainer with the ``rocauc``
evaluator, and the OGB evaluator metrics.

The reference runs its Pallas kernels in interpret mode on the slab
layout (node_cap >= 512 and graph_cap >= 256, so its slab message, pool
and broadcast kernels all run) and plain XLA ops on the plain layout.
Tolerances:

- B4 against ``slab_graph_broadcast``: forward 1e-5, gradient 1e-4,
  padding rows exactly 0 (tests/test_slab_pool.py:159-163);
- against the plain layout: forward rtol 2e-4 / atol 2e-5; against the
  slab layout the reference's own slab-vs-plain tolerance, 2e-4 / 2e-4
  (tests/test_slab_pool.py:126-127);
- gradients rtol 2e-3 / atol 1e-4 * max|g|, BN statistics rtol 1e-4 /
  atol 1e-5 (tests/test_mxu_integration.py:48,79-84);
- loss trajectories and evaluation rtol 1e-3.

The ogb message adds ``x_j``, the ids and the edge features in another
order on each reference layout (``(x_j + ids) + e`` on the plain one,
``x_j + (ids + e)`` on the slab one, which the port's kernel path
follows), so agreement with the plain layout is within tolerance, not
bitwise.  Padding node rows differ by layout (the plain layout gives
them ``vn[0]``, the slab layout and the port 0); every statistic masks
them, so layer outputs are compared on real rows.  Dropout is 0: the
two packages draw different bits.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsn_tpu.config import GSNConfig as JaxConfig
from gsn_tpu.graphs.batching import iterate_batches as jax_batches
from gsn_tpu.nn.embedding import DiscreteEmbedding as JaxEmbedding
from gsn_tpu.nn.filters import GSNLayer as JaxLayer
from gsn_tpu.nn.models import build_model as jax_build_model
from gsn_tpu.ops.pallas.slab_pool import (build_pool_metadata,
                                          slab_graph_broadcast)
from gsn_tpu.train import loop as jax_loop
from gsn_tpu.train import metrics as jax_metrics
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import make_molhiv_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.nn.embedding import DiscreteEmbedding
from gsn_tpu_torch.nn.filters import GSNLayer
from gsn_tpu_torch.nn.models import GNN_OGB, build_model, edge_segments
from gsn_tpu_torch.ops.cuda import slab_combine as k3
from gsn_tpu_torch.ops.cuda import slab_message as k12
from gsn_tpu_torch.ops.cuda import slab_pool as k4
from gsn_tpu_torch.params import flax_to_state_dict, load_flax_variables
from gsn_tpu_torch.train import loop
from gsn_tpu_torch.train import metrics

from test_slab_pool import _synthetic_batch

PLAIN_FWD = dict(rtol=2e-4, atol=2e-5)
SLAB_FWD = dict(rtol=2e-4, atol=2e-4)
SLAB = {"mode": "slab", "flow": "source_to_target",
        "block_n": 128, "block_e": 256}
CAPS = (1024, 2048, 256)
NUM_GRAPHS = 20
D = 16


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def grads_close(got, want):
    """Every parameter gradient, at rtol 2e-3 / atol 1e-4 * max|g|."""
    scale = max(float(np.max(np.abs(w))) for w in want.values())
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=2e-3,
                                   atol=1e-4 * scale, err_msg=name)


def stats_close(model, mutated):
    state = model.state_dict()
    for name, ref in flax_to_state_dict(
            {}, numpy_tree(mutated["batch_stats"])).items():
        np.testing.assert_allclose(state[name].numpy(), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# B4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["graph_broadcast", "graph_broadcast_plain"])
def test_graph_broadcast_matches_slab_kernel(fn):
    """B4 (its autograd Function on CPU tensors, and its plain version)
    against slab_graph_broadcast: vn[batch] on real rows, exact zeros on
    padding rows, and the gradient (the add-pool of the cotangent)."""
    rng = np.random.RandomState(4)
    batch_p, mask, n, node_cap, sizes = _synthetic_batch(rng, 200)
    graph_cap = 256
    meta = build_pool_metadata(batch_p, mask, graph_cap)
    assert meta is not None
    vn = rng.randn(graph_cap, 48).astype(np.float32)
    g_out = rng.randn(node_cap, 48).astype(np.float32)

    def ref(v):
        out = slab_graph_broadcast(
            v, jnp.asarray(meta["recv_local"]), jnp.asarray(meta["fb"]),
            graph_cap, meta["block_g"], meta["block_e"], True)[:node_cap]
        return jnp.sum(out * g_out), out

    (_, out_ref), g_ref = jax.value_and_grad(ref, has_aux=True)(
        jnp.asarray(vn))
    graph_ptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(batch_p[mask], minlength=graph_cap))]
    ).astype(np.int32))
    vt = t(vn).requires_grad_(True)
    out = getattr(k4, fn)(vt, graph_ptr, node_cap)
    assert out.shape == (node_cap, 48)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-5, atol=1e-5)
    assert not out.detach().numpy()[~mask].any()
    (out * t(g_out)).sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-4)


def test_graph_broadcast_counts_nothing_on_cpu():
    """CPU tensors take the plain versions of K4 and K3; no counter
    moves, B4's own included."""
    wrappers = (k4.graph_broadcast, k4.segment_broadcast,
                k3.segment_sum_sorted)
    before = [w.launches for w in wrappers]
    vn = torch.randn(3, 5, requires_grad=True)
    ptr = torch.tensor([0, 2, 2, 6], dtype=torch.int32)
    out = k4.graph_broadcast(vn, ptr, 8)
    torch.testing.assert_close(out, k4.graph_broadcast_plain(vn, ptr, 8))
    out.sum().backward()
    torch.testing.assert_close(vn.grad, torch.tensor(
        [[2.0] * 5, [0.0] * 5, [4.0] * 5]))
    assert [w.launches for w in wrappers] == before


# ---------------------------------------------------------------------------
# K1/K2 in the ogb form, and the db1 repair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b1_grad", [True, False])
def test_edge_message_db1_only_where_needed(b1_grad):
    """The ogb form (no A side, Pe given, relu): every gradient against
    autograd through the plain version; db1 is returned, unchanged, only
    where b1 needs a gradient."""
    rng = np.random.RandomState(11)
    n, e, slots, d = 40, 120, 130, 12
    recv = np.sort(rng.randint(0, n, e))
    send = rng.randint(0, n, e).astype(np.int32)
    seg = k12.EdgeSegments(
        torch.from_numpy(np.concatenate(
            [[0], np.cumsum(np.bincount(recv, minlength=n))]
        ).astype(np.int32)),
        t(send), torch.from_numpy(np.concatenate(
            [[0], np.cumsum(np.bincount(send, minlength=n))]
        ).astype(np.int32)),
        t(np.argsort(send, kind="stable").astype(np.int32)))
    B = t(rng.randn(n, d).astype(np.float32))
    Pe = t(rng.randn(slots, d).astype(np.float32))
    b1 = t(rng.randn(d).astype(np.float32))
    g = t(rng.randn(n, d).astype(np.float32))
    leaves = [x.clone().requires_grad_(True) for x in (B, Pe)]
    bias = b1.clone().requires_grad_(b1_grad)
    out = k12.edge_message_aggregate(None, *leaves, bias, seg, "relu")
    (out * g).sum().backward()
    ref = [x.clone().requires_grad_(True) for x in (B, Pe, b1)]
    out_p = k12.edge_message_fwd_plain(None, *ref, seg.recv_ptr, seg.send)
    (out_p * g).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_p.detach().numpy(),
                               **PLAIN_FWD)
    for a, b in zip(leaves, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=2e-3, atol=1e-5)
    if b1_grad:
        np.testing.assert_allclose(bias.grad.numpy(), ref[2].grad.numpy(),
                                   rtol=2e-3, atol=1e-5)
    else:
        assert bias.grad is None


# ---------------------------------------------------------------------------
# the ogb layer and the bond encoder
# ---------------------------------------------------------------------------

def layer_graphs(scope, num=NUM_GRAPHS, seed=7):
    """Graphs whose node rows, ids and edge features are float rows of
    width D, so each package's batcher places them."""
    rng = np.random.RandomState(seed)
    graphs, _ = make_molhiv_like(num, seed=seed)
    out = []
    for g in graphs:
        n, e = g["x"].shape[0], g["edge_index"].shape[1]
        rows = n if scope == "global" else e
        out.append({
            "x": rng.randn(n, D).astype(np.float32),
            "edge_index": g["edge_index"], "degrees": g["degrees"],
            "identifiers": rng.randn(rows, D).astype(np.float32),
            "ids_on_edges": scope == "local",
            "edge_features": rng.randn(e, D).astype(np.float32),
            "y": g["y"]})
    return out


@pytest.mark.parametrize("scope", ["local", "global"])
@pytest.mark.parametrize("path,layout", [("kernel", "slab"),
                                         ("kernel", "plain"),
                                         ("per_edge", "plain")])
def test_ogb_layer_matches(scope, path, layout):
    """GSNLayer(msg_kind='ogb') in train mode: real node rows, every
    parameter gradient of a masked loss and the update MLP's BN
    statistics.  The port's kernel path (K1/K2's plain versions on the
    CPU) against both reference layouts; its per-edge path against the
    plain layout."""
    graphs = layer_graphs(scope)
    jb = next(jax_batches(copy.deepcopy(graphs), NUM_GRAPHS, caps=CAPS,
                          y_dtype=np.float32,
                          mxu_layout=SLAB if layout == "slab" else None))
    tb = next(iterate_batches(graphs, NUM_GRAPHS, caps=CAPS,
                              y_dtype=np.float32)).to("cpu")
    seg = None
    if layout == "slab":
        assert jb.seg_mode == "slab"
        seg = (jb.seg_recv_local, jb.seg_chunks, jb.seg_block_n,
               jb.seg_send_local, jb.seg_mode, jb.seg_in_degree,
               jb.seg_s_s, jb.seg_kc)
    jl = JaxLayer(d_up=D, d_h=(2 * D,), msg_kind="ogb", id_scope=scope,
                  use_ids=True, use_edge_features=True,
                  flow="source_to_target", activation_mlp="relu",
                  bn_mlp=True)
    args = (jnp.asarray(jb.x), jb.edge_index, jb.identifiers, None,
            jb.edge_features, jb.node_mask, jb.edge_mask)
    v = jl.init(jax.random.PRNGKey(0), *args, False, seg=seg)
    mask = np.asarray(jb.node_mask)
    w = np.random.RandomState(3).randn(mask.shape[0], D).astype(np.float32)
    w *= mask[:, None]

    def loss(params):
        out, mutated = jl.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, *args,
            True, seg=seg, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mutated)

    (_, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])

    layer = GSNLayer(D, D, None, (2 * D,), msg_kind="ogb", id_scope=scope,
                     use_ids=True, use_edge_features=True, d_id=D, d_ef=D,
                     flow="source_to_target", activation_mlp="relu",
                     bn_mlp=True).train()
    load_flax_variables(layer, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    out = layer(tb.x, tb.edge_index, tb.identifiers, None, tb.edge_features,
                tb.node_mask, tb.edge_mask,
                edge_segments(tb) if path == "kernel" else None)
    (out * t(w)).sum().backward()
    fwd = SLAB_FWD if layout == "slab" else PLAIN_FWD
    np.testing.assert_allclose(out.detach().numpy()[mask],
                               np.asarray(jout)[mask], **fwd)
    grads_close({n: p.grad.numpy() for n, p in layer.named_parameters()},
                flax_to_state_dict(numpy_tree(jgrads)))
    stats_close(layer, mutated)


def test_bond_encoder_matches():
    rng = np.random.RandomState(0)
    x = np.stack([rng.randint(0, v, 50) for v in (5, 6, 2)], 1)
    jenc = JaxEmbedding("bond_encoder", 3, None, 16)
    v = jenc.init(jax.random.PRNGKey(1), jnp.asarray(x))
    enc = DiscreteEmbedding("bond_encoder", 3, None, 16)
    load_flax_variables(enc, numpy_tree(v["params"]))
    assert enc.d_out == 16
    np.testing.assert_allclose(enc(t(x)).detach().numpy(),
                               np.asarray(jenc.apply(v, jnp.asarray(x))),
                               **PLAIN_FWD)


# ---------------------------------------------------------------------------
# GNN_OGB
# ---------------------------------------------------------------------------

def molhiv_kwargs(d_id, **over):
    """bench.py::molhiv_cfg at d=16 (hidden 32), 3 layers, dropout 0."""
    kw = dict(model_name="GSN_edge_sparse_ogb", num_layers=3, d_out=D,
              d_h=2 * D, out_features=1, msg_kind="ogb", id_scope="local",
              vn=True, dropout_features=0.0, readout="mean",
              final_projection=[False], jk_mlp=False,
              id_embedding="embedding", d_out_id_embedding=D,
              input_node_encoder="atom_encoder", edge_encoder="bond_encoder",
              input_vn_encoder="embedding", in_features=9,
              in_edge_features=3, d_in_id=d_id)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def molhiv():
    graphs, d_id = make_molhiv_like(NUM_GRAPHS, seed=1)
    out = dict(graphs=graphs, d_id=d_id)
    for layout in ("plain", "slab"):
        out[layout] = next(jax_batches(
            copy.deepcopy(graphs), NUM_GRAPHS, caps=CAPS, y_shape=(),
            y_dtype=np.float32, mxu_layout=SLAB if layout == "slab"
            else None))
    assert out["slab"].seg_mode == "slab"
    assert out["slab"].pool_recv_local is not None
    out["ours"] = next(iterate_batches(graphs, NUM_GRAPHS, caps=CAPS,
                                       y_shape=(),
                                       y_dtype=np.float32)).to("cpu")
    return out


# the molhiv configuration, and one that turns on the model's other
# options: residual, learned eps, injected ids, every layer in the readout
VARIANTS = {
    "molhiv": {},
    "residual": dict(residual=True, train_eps=True, inject_ids=True,
                     final_projection=[True], readout="sum",
                     vn_pooling="mean"),
}


@pytest.mark.parametrize("layout", ["plain", "slab"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gnn_ogb_matches(molhiv, variant, layout):
    """GNN_OGB through the weight bridge: eval and train predictions,
    every parameter gradient of the BCE loss, and every running BN
    statistic after one training forward (the VN MLP's graph BN
    included: 20 real graphs in 256 slots)."""
    kw = molhiv_kwargs(molhiv["d_id"], **VARIANTS[variant])
    jb = molhiv[layout]
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), molhiv["plain"], train=False)
    model = build_model(GSNConfig(**kw))
    assert isinstance(model, GNN_OGB)
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    fwd = SLAB_FWD if layout == "slab" else PLAIN_FWD
    tb = molhiv["ours"]

    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jb)), **fwd)

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return (jax_metrics.bce_with_logits_loss(out, jb.y, jb.graph_mask),
                (out, mutated))

    (jl, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])
    model.train()
    out = model(tb)
    tl = metrics.bce_with_logits_loss(out, tb.y, tb.graph_mask)
    tl.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **fwd)
    np.testing.assert_allclose(tl.item(), float(jl), **fwd)
    grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                flax_to_state_dict(numpy_tree(jgrads)))
    stats_close(model, mutated)


def test_mpnn_ogb_without_virtual_node_matches(molhiv):
    """MPNN_edge_sparse_ogb with no virtual node and no ids (the
    model's other entry), on the plain layout."""
    kw = molhiv_kwargs(molhiv["d_id"], model_name="MPNN_edge_sparse_ogb",
                       vn=False)
    jb = molhiv["plain"]
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(2), jb, train=False)
    model = build_model(GSNConfig(**kw)).train()
    assert not hasattr(model, "vn_encoder")
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    jout, mutated = jm.apply(v, jb, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        out = model(molhiv["ours"])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **PLAIN_FWD)
    stats_close(model, mutated)


def test_bridge_maps_the_full_molhiv_tree(molhiv):
    """bench.py::molhiv_cfg's own depth and structure (5 layers, 4 VN
    MLPs) at d=8: every flax leaf maps to a module entry and back, and
    the VN encoder's table starts at zero (zeros_init)."""
    kw = molhiv_kwargs(molhiv["d_id"], num_layers=5, d_out=8, d_h=16,
                       d_out_id_embedding=8)
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), molhiv["plain"], train=False)
    model = build_model(GSNConfig(**kw), torch.Generator().manual_seed(0))
    vn_table = model.vn_encoder.MultiEmbedding_0.embed_0.weight
    assert vn_table.shape == (1, 8) and not vn_table.any()
    mapped = flax_to_state_dict(numpy_tree(v["params"]),
                                numpy_tree(v["batch_stats"]))
    assert set(mapped) == set(model.state_dict())
    assert {k.split(".")[0] for k in mapped} >= {
        "vn_encoder", "id_encoder_0", "lin_proj",
        *(f"edge_encoder_{i}" for i in range(5)),
        *(f"conv_{i}" for i in range(5)), *(f"bn_{i}" for i in range(5)),
        *(f"mlp_vn_{i}" for i in range(4))}
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))


# ---------------------------------------------------------------------------
# the trainer and the evaluator
# ---------------------------------------------------------------------------

def test_trainer_trajectory_and_rocauc_match(molhiv):
    """``evaluate`` with the rocauc evaluator on the whole set, then
    three BCE Trainer.train_steps (Adam lr 1e-3) on one batch in both
    packages from the same carried weights."""
    graphs = molhiv["graphs"]
    kw = molhiv_kwargs(molhiv["d_id"])
    tkw = dict(lr=1e-3, batch_size=8, scheduler="None",
               loss_fn="BCEWithLogitsLoss", prediction_fn="None",
               evaluator="rocauc")
    jt = jax_loop.Trainer(JaxConfig(**kw),
                          jax_loop.TrainerConfig(shuffle=False, **tkw),
                          graphs)
    jb = molhiv["slab"]
    jstate = jt.init_state(jb, seed=0)
    init = jstate
    jeval = jt.evaluate(jstate, graphs)
    key = jax.random.PRNGKey(0)
    jlosses = []
    for _ in range(3):
        jstate, jl = jt._jit_train_step(jstate, jb, 1e-3, key)
        jlosses.append(float(jl))

    tt = loop.Trainer(GSNConfig(**kw), loop.TrainerConfig(**tkw), graphs,
                      device="cpu")
    tstate = tt.init_state(seed=0)
    load_flax_variables(tstate.model, numpy_tree(init.params),
                        numpy_tree(init.batch_stats))
    teval = tt.evaluate(tstate, graphs)
    assert 0.0 <= teval[1] <= 1.0
    np.testing.assert_allclose(teval, jeval, rtol=1e-3)
    tlosses = []
    for _ in range(3):
        tstate, tl = tt.train_step(tstate, molhiv["ours"])
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)


def test_unknown_evaluator_raises(molhiv):
    kw = molhiv_kwargs(molhiv["d_id"])
    tt = loop.Trainer(GSNConfig(**kw),
                      loop.TrainerConfig(batch_size=8, evaluator="ap"),
                      molhiv["graphs"], device="cpu")
    with pytest.raises(ValueError, match="evaluator"):
        tt.evaluate(tt.init_state(seed=0), molhiv["graphs"])


@pytest.mark.parametrize("tasks", [1, 3])
def test_rocauc_and_ap_match(tasks):
    """Tied scores, unlabeled (NaN) targets and, with three tasks, one
    task with a single class (skipped by both)."""
    rng = np.random.RandomState(tasks)
    y = (rng.rand(60, tasks) > 0.6).astype(np.float64)
    y[rng.rand(60, tasks) < 0.15] = np.nan
    if tasks > 1:
        y[:, 2] = 1.0
    score = np.round(rng.randn(60, tasks), 1)
    for ours, ref in ((metrics.roc_auc_score, jax_metrics.roc_auc_score),
                      (metrics.average_precision_score,
                       jax_metrics.average_precision_score)):
        assert ours(y, score) == ref(y, score)
    with pytest.raises(ValueError, match="labels"):
        metrics.roc_auc_score(np.ones(5), np.arange(5.0))
