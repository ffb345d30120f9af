"""Fused BN in the message MLP (``bn_mlp`` on the ``general`` kind)
against the reference package on the CPU: K1/K2's ``id_sq`` moments
pass, K3 from f32 rows into bf16, the bf16 ``GSNLayer`` and the zinc
``GNNSubstructures`` that fold BN into the first layer through it, and
the f32 ``bn_mlp`` model, which stays on the per-edge path.

The reference runs its Pallas kernels in interpret mode and its models
on the slab layout, where it routes bf16 ``bn_mlp`` messages through the
fused pass (``gsn_tpu/nn/filters.py:162-193, 355-371``); the port runs
its kernels' plain versions.  Tolerances:

- ``id_sq`` keeps its moments, dH and db1 in f32 for either data dtype,
  so they are held at the f32 tolerances (forward rtol 2e-4 / atol
  2e-5, gradients rtol 2e-3 / atol 1e-4·max|g|); dA, dB and dPe come
  back in the data dtype, at those tolerances in f32 and at rtol 2e-2 /
  atol 1e-2·max|want| in bf16 (the reference's chunk sums round in
  another order);
- K3 f32 → bf16: the f32 sum rounded once, equal;
- bf16 models (tests/test_compute_dtype.py:80-85): prediction and loss
  rel 2e-2, the all-parameter gradient cosine > 0.99, BN running
  statistics rtol 2e-2;
- the f32 ``bn_mlp`` model at the f32 tolerances.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsn_tpu.config import GSNConfig as JaxConfig
from gsn_tpu.graphs.batching import iterate_batches as jax_batches
from gsn_tpu.nn.filters import GSNLayer as JaxLayer
from gsn_tpu.nn.models import build_model as jax_build_model
from gsn_tpu.ops.pallas.slab_message import slab_edge_message_aggregate
from gsn_tpu.train import metrics as jax_metrics
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.nn import filters
from gsn_tpu_torch.nn.filters import GSNLayer
from gsn_tpu_torch.nn.models import build_model, edge_segments
from gsn_tpu_torch.ops.cuda import slab_combine as k3
from gsn_tpu_torch.ops.cuda import slab_message as k12
from gsn_tpu_torch.params import flax_to_state_dict, load_flax_variables
from gsn_tpu_torch.train import metrics

from test_slab_message import BE, BN
from test_slab_message import setup as slab_setup
from test_torch_bf16 import (REL, assert_bf16_close, bf16, cosine, csr, f32,
                             flat, model_case, numpy_tree, rel_close)
from test_torch_ogb import CAPS, D, NUM_GRAPHS, SLAB, layer_graphs

FWD = dict(rtol=2e-4, atol=2e-5)


def grad_close(got, want, err_msg=""):
    want = f32(want)
    np.testing.assert_allclose(f32(got), want, rtol=2e-3,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# K1/K2 in id_sq mode, and K3 f32 -> bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_a,with_pe", [(True, True), (False, False)])
def test_id_sq_matches_slab_kernel(dtype, has_a, with_pe):
    """EdgeMessageAggregate(act="id_sq") against the slab kernel's id_sq
    mode with f32 or bf16 data: the f32 [H, H²] sums and db1 at the f32
    tolerances, dA, dB and dPe in the data dtype."""
    s = slab_setup(with_pe=with_pe, e_pad=0 if with_pe else 37)
    N, d = s["N"], s["A"].shape[1]
    g_out = np.random.RandomState(9).randn(s["num_nodes"], 2 * d).astype(
        np.float32)
    bf = dtype == "bfloat16"

    def data(a):
        if bf:
            return bf16(a)
        return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))

    A_j, A_t = data(s["A"] if has_a else np.zeros_like(s["A"]))
    B_j, B_t = data(s["B"])
    Pe_j, Pe_t = (data(s["Pe"]) if with_pe
                  else (jnp.zeros((1, 1), A_j.dtype), None))

    def ref(A, B, Pe, b):
        return slab_edge_message_aggregate(
            A, B, Pe, b, jnp.asarray(s["meta"]["recv_local"]),
            jnp.asarray(s["meta"]["send_local"]), jnp.asarray(s["fb_wf"]),
            N, s["num_nodes"], BN, BE, "id_sq", with_pe, True, None, dtype,
            has_a, s["meta"]["s_s"])

    args = (A_j, B_j, Pe_j, jnp.asarray(s["b1"]))
    out_ref = ref(*args)
    assert out_ref.dtype == jnp.float32
    grads = jax.grad(lambda *a: jnp.sum(ref(*a) * g_out),
                     argnums=(0, 1, 2, 3))(*args)

    send = s["send"].astype(np.int32)
    seg = k12.EdgeSegments(csr(s["recv"], N), torch.from_numpy(send),
                           csr(send, N), torch.from_numpy(
                               np.argsort(send, kind="stable")
                               .astype(np.int32)))
    leaves = {"A": A_t if has_a else None, "B": B_t, "Pe": Pe_t,
              "b1": torch.from_numpy(s["b1"])}
    for x in leaves.values():
        if x is not None:
            x.requires_grad_(True)
    out = k12.edge_message_aggregate(*leaves.values(), seg, "id_sq")
    assert out.dtype == torch.float32 and out.shape == (N, 2 * d)
    np.testing.assert_allclose(out.detach().numpy(), f32(out_ref)[:N],
                               **FWD)
    (out * torch.from_numpy(g_out[:N])).sum().backward()
    want = dict(zip(("A", "B", "Pe", "b1"), grads))
    for name in ("A", "B", "Pe"):
        x = leaves[name]
        if x is None:
            continue
        assert x.grad.dtype == x.dtype
        w = want[name][:N] if name != "Pe" else want[name]
        if bf:
            assert_bf16_close(x.grad, w, f"d{name}")
        else:
            grad_close(x.grad, w, f"d{name}")
    assert leaves["b1"].grad.dtype == torch.float32
    grad_close(leaves["b1"].grad, want["b1"], "db1")


def test_id_sq_plain_moments_and_dh():
    """The id_sq plain versions from their definitions: the moments are
    Σ [H, H²] of the f32 pre-activation (not rounded, also on bf16
    data), and dH = g1 + 2H·g2 from the f32 cotangent."""
    bf = torch.bfloat16
    ptr = torch.tensor([0, 2, 2], dtype=torch.int32)
    send = torch.tensor([1, 0], dtype=torch.int32)
    A = torch.tensor([[0.5], [0.0]], dtype=bf)
    B = torch.tensor([[1.0], [2.0 ** -9]]).to(bf)
    b1 = torch.tensor([2.0 ** -10])
    hs = k12.edge_message_fwd(A, B, None, b1, ptr, send, "id_sq")
    h = torch.tensor([0.5 + 2.0 ** -9 + 2.0 ** -10, 1.5 + 2.0 ** -10])
    assert hs.dtype == torch.float32
    torch.testing.assert_close(hs, torch.tensor(
        [[float(h.sum()), float((h * h).sum())], [0.0, 0.0]]))
    g = torch.tensor([[1.0, 2.0 ** -8], [5.0, 5.0]])
    dH, dA = k12.edge_message_bwd_recv(A, B, None, b1, g, ptr, send,
                                       "id_sq", 3)
    want = 1.0 + 2.0 * h * 2.0 ** -8
    assert dH.dtype == torch.float32 and dA.dtype == bf
    torch.testing.assert_close(dH[:, 0], torch.cat([want, torch.zeros(1)]))
    assert float(dA[0, 0]) == float(want.sum().to(bf))


def test_segment_sum_f32_rows_into_bf16_round_the_f32_sum_once():
    """K3 f32 -> bf16 is the f32 sum rounded once: rows of eighths sum
    exactly in f32 in any order, and the sums need more than bf16's 8
    significant bits."""
    rng = np.random.RandomState(4)
    rows = rng.randint(-400, 400, (60, 7)).astype(np.float32) / 8
    keys = np.sort(rng.randint(0, 9, 60))
    perm = rng.permutation(60).astype(np.int32)
    exact = np.zeros((9, 7), np.float32)
    np.add.at(exact, keys, rows[perm])
    got = k3.segment_sum_sorted(torch.from_numpy(rows), csr(keys, 9),
                                torch.from_numpy(perm), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(exact).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert not torch.equal(want.float(), torch.from_numpy(exact))


# ---------------------------------------------------------------------------
# the bf16 GSNLayer and zinc model with bn_mlp
# ---------------------------------------------------------------------------

def test_general_layer_bf16_bn_mlp_matches():
    """GSNLayer(general, bn_mlp, bf16) in train mode on the slab layout:
    real node rows, the all-parameter gradient cosine and the BN
    statistics of the message MLP (folded) and the update MLP."""
    graphs = layer_graphs("global")
    jb = next(jax_batches(copy.deepcopy(graphs), NUM_GRAPHS, caps=CAPS,
                          y_dtype=np.float32, mxu_layout=SLAB))
    tb = next(iterate_batches(graphs, NUM_GRAPHS, caps=CAPS,
                              y_dtype=np.float32)).to("cpu")
    assert jb.seg_mode == "slab"
    seg = (jb.seg_recv_local, jb.seg_chunks, jb.seg_block_n,
           jb.seg_send_local, jb.seg_mode, jb.seg_in_degree, jb.seg_s_s,
           jb.seg_kc)
    kw = dict(msg_kind="general", id_scope="global", use_ids=True,
              use_edge_features=True, flow="source_to_target",
              activation_mlp="relu", bn_mlp=True)
    jl = JaxLayer(d_up=D, d_h=(D,), compute_dtype="bfloat16", **kw)
    x, ids, ef = (bf16(np.asarray(a))
                  for a in (jb.x, jb.identifiers, jb.edge_features))
    args = (x[0], jb.edge_index, ids[0], None, ef[0], jb.node_mask,
            jb.edge_mask)
    v = jl.init(jax.random.PRNGKey(0), *args, False, seg=seg)
    mask = np.asarray(jb.node_mask)
    w = np.random.RandomState(3).randn(mask.shape[0], D).astype(np.float32)
    w *= mask[:, None]

    def loss(params):
        out, mutated = jl.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, *args,
            True, seg=seg, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * w), (out, mutated)

    (_, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])

    layer = GSNLayer(D, D, None, (D,), d_id=D, d_ef=D,
                     compute_dtype=torch.bfloat16, **kw).train()
    load_flax_variables(layer, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    assert layer.msg_fn.fusable
    n = tb.x.shape[0]
    out = layer(x[1][:n], tb.edge_index, ids[1][:n], None,
                ef[1][:tb.edge_features.shape[0]], tb.node_mask,
                tb.edge_mask, edge_segments(tb), tb.in_degree)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w[:n])).sum().backward()
    rel_close(out.detach()[mask[:n]], f32(jout)[mask], "layer output")
    want = flax_to_state_dict(numpy_tree(jgrads))
    got = {k: p.grad.numpy() for k, p in layer.named_parameters()}
    assert set(got) == set(want)
    assert cosine(flat(got), flat(want)) > 0.99
    state = layer.state_dict()
    for name, ref in flax_to_state_dict(
            {}, numpy_tree(mutated["batch_stats"])).items():
        rel_close(state[name], ref, name)


@pytest.fixture(scope="module")
def zinc_bnmlp():
    kw, graphs, jb, tb, loss = model_case("zinc")
    kw["bn_mlp"] = True
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), jb, train=False)
    return dict(kw=kw, graphs=graphs, jb=jb, tb=tb, jm=jm, v=v)


def bridged(case, **over):
    model = build_model(GSNConfig(**{**case["kw"], **over}))
    load_flax_variables(model, numpy_tree(case["v"]["params"]),
                        numpy_tree(case["v"]["batch_stats"]))
    return model


def test_zinc_bf16_bn_mlp_matches(zinc_bnmlp):
    """The zinc GSN-EF model with bf16 + bn_mlp against the reference's
    on the slab layout: eval prediction, train prediction and L1 loss,
    the all-parameter gradient cosine and every running BN statistic
    (the folded message BN's among them)."""
    c = zinc_bnmlp
    jm, v, jb, tb = c["jm"], c["v"], c["jb"], c["tb"]
    model = bridged(c).eval()
    with torch.no_grad():
        rel_close(model(tb), jm.apply(v, jb), "eval")

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return jax_metrics.l1_loss(out, jb.y, jb.graph_mask), (out, mutated)

    (jl, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])
    model.train()
    out = model(tb)
    tl = metrics.l1_loss(out, tb.y, tb.graph_mask)
    tl.backward()
    rel_close(out.detach(), jout, "train prediction")
    assert tl.item() == pytest.approx(float(jl), rel=REL)
    want = flax_to_state_dict(numpy_tree(jgrads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    assert cosine(flat(got), flat(want)) > 0.99
    state = model.state_dict()
    stats = flax_to_state_dict({}, numpy_tree(mutated["batch_stats"]))
    assert "conv_0.msg_fn.bn_0.running_mean" in stats
    for name, ref in stats.items():
        rel_close(state[name], ref, name)


def test_bn_mlp_routes_by_compute_dtype(zinc_bnmlp, monkeypatch):
    """bf16 bn_mlp messages take the kernels, id_sq then relu in each
    layer in training and relu alone in eval (the running statistics
    fold in); f32 bn_mlp messages take the per-edge path."""
    calls = []
    real = filters.edge_message_aggregate
    monkeypatch.setattr(filters, "edge_message_aggregate",
                        lambda *a: calls.append((a[-1], a[1].dtype))
                        or real(*a))
    tb, L = zinc_bnmlp["tb"], zinc_bnmlp["kw"]["num_layers"]
    bf = torch.bfloat16
    model = bridged(zinc_bnmlp).train()
    model(tb)
    assert calls == [("id_sq", bf), ("relu", bf)] * L
    calls.clear()
    model.eval()(tb)
    assert calls == [("relu", bf)] * L
    calls.clear()
    f32_model = bridged(zinc_bnmlp, compute_dtype=None).train()
    assert not f32_model.conv_0.msg_fn.fusable
    f32_model(tb)
    assert calls == []


@pytest.mark.parametrize("train", [False, True])
def test_zinc_f32_bn_mlp_per_edge_matches(zinc_bnmlp, train):
    """bn_mlp on the general kind in f32 takes the per-edge path in both
    packages: prediction, and in training every parameter gradient and
    running BN statistic, at the f32 tolerances."""
    kw = {**zinc_bnmlp["kw"], "compute_dtype": None}
    jb, tb = zinc_bnmlp["jb"], zinc_bnmlp["tb"]
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(1), jb, train=False)
    model = build_model(GSNConfig(**kw))
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    if not train:
        with torch.no_grad():
            np.testing.assert_allclose(model.eval()(tb).numpy(),
                                       np.asarray(jm.apply(v, jb)), **FWD)
        return

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return jax_metrics.l1_loss(out, jb.y, jb.graph_mask), mutated

    (jl, mutated), jgrads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    model.train()
    tl = metrics.l1_loss(model(tb), tb.y, tb.graph_mask)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **FWD)
    want = flax_to_state_dict(numpy_tree(jgrads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=2e-3,
                                   atol=1e-4 * scale, err_msg=name)
    state = model.state_dict()
    for name, ref in flax_to_state_dict(
            {}, numpy_tree(mutated["batch_stats"])).items():
        np.testing.assert_allclose(state[name].numpy(), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
