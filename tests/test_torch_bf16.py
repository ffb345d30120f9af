"""The port's bf16 compute dtype against the reference package's, on the
CPU.

Both packages get the same seeded numpy inputs.  The reference runs its
Pallas kernels with ``data_dtype="bfloat16"`` as its own tests run them
here (interpret mode or the chunk-by-chunk emulation), and its models on
the slab layout, where it rounds pooled rows to bf16 as the port does;
the port runs its kernels' plain versions.  The reference also rounds
each chunk's partial sums to bf16 before combining them, which the
port, having no chunks, does not (``ROADMAP.md`` B, "precision
contract"), so the gates are tolerances, not bits, except where both
copy or mask bf16 values:

- K1 forward, dA and dB: rtol 2e-2 / atol 1e-2·max|want|; dPe bit for
  bit; db1 (an f32 sum of the same bf16 dH) rtol 2e-3 / atol
  1e-4·max|want|;
- K3 bf16 → f32: the f32 tolerances (both are f32 sums of the same bf16
  values); K3 bf16 → bf16: the f32 sum rounded once, equal;
- the pool: rtol 2e-2; its backward and B4's forward bit for bit; B4's
  backward rtol 2e-2;
- models (tests/test_compute_dtype.py:80-85): prediction and loss rel
  2e-2, the all-parameter gradient cosine > 0.99, BN running statistics
  rtol 2e-2 (atol 2e-2·max|want|, for means near 0); three trainer
  losses rel 2e-2.
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
from gsn_tpu.nn.models import build_model as jax_build_model
from gsn_tpu.ops.pallas.slab_combine import combine_kc, slab_combine_sum
from gsn_tpu.ops.pallas.slab_message import slab_edge_message_aggregate
from gsn_tpu.ops.pallas.slab_pool import (build_pool_metadata,
                                          slab_add_pool,
                                          slab_graph_broadcast)
from gsn_tpu.train import loop as jax_loop
from gsn_tpu.train import metrics as jax_metrics
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import make_molhiv_like, make_zinc_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.nn import filters
from gsn_tpu_torch.nn.models import build_model
from gsn_tpu_torch.ops.cuda import slab_combine as k3
from gsn_tpu_torch.ops.cuda import slab_message as k12
from gsn_tpu_torch.ops.cuda import slab_pool as k4
from gsn_tpu_torch.params import flax_to_state_dict, load_flax_variables
from gsn_tpu_torch.train import loop
from gsn_tpu_torch.train import metrics

from test_slab_message import BE, BN
from test_slab_message import setup as slab_setup
from test_slab_pool import _synthetic_batch
from test_torch_model import zinc_kwargs
from test_torch_ogb import molhiv_kwargs

BF = jnp.bfloat16
SLAB = {"mode": "slab", "flow": "source_to_target",
        "block_n": 128, "block_e": 256}
CAPS = (1024, 2048, 256)
NUM_GRAPHS = 20
REL = 2e-2


def bf16(a):
    """(the bf16 rounding of ``a`` as a jnp bf16 array, the same values
    as a torch bf16 tensor)."""
    j = jnp.asarray(np.asarray(a, np.float32)).astype(BF)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def f32(x):
    """A torch or jnp array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_bf16_close(got, want, err_msg=""):
    want = f32(want)
    atol = 1e-2 * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(f32(got), want, rtol=REL, atol=atol,
                               err_msg=err_msg)


def csr(keys, num_segments):
    ptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=num_segments), out=ptr[1:])
    return torch.from_numpy(ptr.astype(np.int32))


def numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)),
        flax.core.unfreeze(tree))


# ---------------------------------------------------------------------------
# K1/K2 (and K3 for dB) in bf16 against slab_edge_message_aggregate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("with_pe", [True, False])
@pytest.mark.parametrize("has_a", [True, False])
def test_edge_message_bf16_matches_slab_kernel(act, with_pe, has_a):
    """EdgeMessageAggregate on bf16 A, B, Pe (f32 b1) against the slab
    kernel with data_dtype="bfloat16": the forward and every gradient,
    with and without Pe and the A side (has_a=False is the ogb form)."""
    s = slab_setup(with_pe=with_pe, e_pad=0 if with_pe else 37)
    N = s["N"]
    d = s["A"].shape[1]
    g_out = np.random.RandomState(7).randn(s["num_nodes"], d).astype(
        np.float32)
    A_j, A_t = bf16(s["A"] if has_a else np.zeros_like(s["A"]))
    B_j, B_t = bf16(s["B"])
    Pe_j, Pe_t = bf16(s["Pe"]) if with_pe else (jnp.zeros((1, 1), BF), None)
    b1 = s["b1"]

    def ref(A, B, Pe, b):
        return slab_edge_message_aggregate(
            A, B, Pe, b, jnp.asarray(s["meta"]["recv_local"]),
            jnp.asarray(s["meta"]["send_local"]), jnp.asarray(s["fb_wf"]),
            N, s["num_nodes"], BN, BE, act, with_pe, True, None, "bfloat16",
            has_a, s["meta"]["s_s"])

    args = (A_j, B_j, Pe_j, jnp.asarray(b1))
    out_ref = ref(*args)
    assert out_ref.dtype == BF
    grads = jax.grad(lambda *a: jnp.sum(ref(*a).astype(jnp.float32)
                                        * g_out), argnums=(0, 1, 2, 3))(*args)

    send = s["send"].astype(np.int32)
    seg = k12.EdgeSegments(csr(s["recv"], N), torch.from_numpy(send),
                           csr(send, N), torch.from_numpy(
                               np.argsort(send, kind="stable")
                               .astype(np.int32)))
    leaves = {"A": A_t if has_a else None, "B": B_t, "Pe": Pe_t,
              "b1": torch.from_numpy(b1)}
    for x in leaves.values():
        if x is not None:
            x.requires_grad_(True)
    out = k12.edge_message_aggregate(*leaves.values(), seg, act)
    assert out.dtype == torch.bfloat16
    assert_bf16_close(out, out_ref[:N], "forward")
    (out.float() * torch.from_numpy(g_out[:N])).sum().backward()
    want = dict(zip(("A", "B", "Pe", "b1"), grads))
    for name in ("A", "B"):
        if leaves[name] is not None:
            assert leaves[name].grad.dtype == torch.bfloat16
            assert_bf16_close(leaves[name].grad, want[name][:N], f"d{name}")
    if with_pe:
        assert leaves["Pe"].grad.dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(leaves["Pe"].grad),
                                      f32(want["Pe"]), err_msg="dPe")
    db1 = leaves["b1"].grad
    assert db1.dtype == torch.float32
    np.testing.assert_allclose(db1.numpy(), f32(want["b1"]), rtol=2e-3,
                               atol=1e-4 * float(np.abs(f32(want["b1"]))
                                                 .max()))


def test_edge_message_plain_rounds_messages_and_keeps_the_f32_mask():
    """K1's plain version rounds each message to bf16 before the f32 sum
    and K2's masks by the f32 pre-activation.  Messages 1 and 1 + 9·2^-10
    round to 1 and 1 + 2^-7, whose sum 2 + 2^-7 rounds to 2 (the unrounded
    sum would round to 2 + 2^-6); H = (1 + 2^-9) - 1 is 2^-9 > 0 in f32
    but 0 if B + Pe were rounded to bf16 first."""
    one = torch.tensor([[1.0]], dtype=torch.bfloat16)
    ptr = torch.tensor([0, 2], dtype=torch.int32)
    send = torch.tensor([0, 0], dtype=torch.int32)
    pe = torch.tensor([[0.0], [9 * 2.0 ** -10]], dtype=torch.bfloat16)
    out = k12.edge_message_fwd_plain(None, one, pe, torch.zeros(1), ptr,
                                     send, "identity")
    assert out.dtype == torch.bfloat16 and float(out) == 2.0
    dH, _ = k12.edge_message_bwd_recv_plain(
        None, one, torch.full((2, 1), 2.0 ** -9, dtype=torch.bfloat16),
        torch.tensor([-1.0]), torch.ones(1, 1, dtype=torch.bfloat16), ptr,
        send, "relu")
    assert dH.dtype == torch.bfloat16 and dH.float().tolist() == [[1.0],
                                                                  [1.0]]


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def test_segment_sum_bf16_rows_match_slab_combine():
    """K3 bf16 -> f32 against slab_combine_sum on the same bf16 slabs, at
    the f32 tolerances: both sum the same bf16 values in f32."""
    rng = np.random.RandomState(2)
    C, span, block_n, d, num_blocks = 17, 3, 8, 10, 9
    key = np.sort(rng.randint(0, num_blocks - span + 1, C)).astype(np.int32)
    slabs_j, slabs_t = bf16(rng.randn(C, span * block_n, d))
    want = np.asarray(slab_combine_sum(
        slabs_j, jnp.asarray(key), span, num_blocks, block_n, d,
        combine_kc(key, span, num_blocks), interpret=True))
    tt, jj, ii = np.meshgrid(np.arange(C), np.arange(span),
                             np.arange(block_n), indexing="ij")
    out_row = ((key[tt] + jj) * block_n + ii).reshape(-1)
    perm = np.argsort(out_row, kind="stable").astype(np.int32)
    got = k3.segment_sum_sorted(slabs_t.reshape(-1, d),
                                csr(out_row, num_blocks * block_n),
                                torch.from_numpy(perm))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_segment_sum_bf16_out_rounds_the_f32_sum_once():
    """K3 bf16 -> bf16 is the f32 sum rounded once to bf16: rows of
    eighths sum exactly in f32 in any order, and the sums need more than
    bf16's 8 significant bits."""
    rng = np.random.RandomState(3)
    rows = rng.randint(-400, 400, (60, 7)).astype(np.float32) / 8
    keys = np.sort(rng.randint(0, 9, 60))
    perm = rng.permutation(60).astype(np.int32)
    ptr = csr(keys, 9)
    rows_t = torch.from_numpy(rows).to(torch.bfloat16)
    exact = np.zeros((9, 7), np.float32)
    np.add.at(exact, keys, rows_t.float().numpy()[perm])
    got = k3.segment_sum_sorted(rows_t, ptr, torch.from_numpy(perm),
                                torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(exact).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert not torch.equal(want.float(), torch.from_numpy(exact))


# ---------------------------------------------------------------------------
# the pool (B3) and the virtual node's broadcast (B4)
# ---------------------------------------------------------------------------

def pool_setup(seed, node_rows=250, graph_cap=256, d=32):
    rng = np.random.RandomState(seed)
    batch_p, mask, n, node_cap, sizes = _synthetic_batch(rng, node_rows)
    meta = build_pool_metadata(batch_p, mask, graph_cap)
    assert meta is not None
    return rng, dict(meta=meta, mask=mask, node_cap=node_cap,
                     graph_cap=graph_cap, d=d,
                     graph_ptr=csr(batch_p[mask], graph_cap),
                     n_pad=meta["recv_local"].shape[0])


def test_add_pool_bf16_matches_slab_add_pool():
    """add_pool on bf16 rows (f32 pooled rows, rtol 2e-2) and its
    backward (the f32 cotangent rounded to bf16 and copied to each node,
    0 on padding rows) bit for bit against jax.vjp of slab_add_pool."""
    rng, p = pool_setup(1)
    x_j, x_t = bf16(rng.randn(p["node_cap"], p["d"]))
    g = rng.randn(p["graph_cap"], p["d"]).astype(np.float32)
    m = p["meta"]

    def ref(xp):
        return slab_add_pool(xp, jnp.asarray(m["recv_local"]),
                             jnp.asarray(m["fb"]), p["graph_cap"],
                             m["block_g"], m["block_e"], True)

    xp = jnp.pad(x_j, ((0, p["n_pad"] - p["node_cap"]), (0, 0)))
    out_ref, vjp = jax.vjp(ref, xp)
    (dx_ref,) = vjp(jnp.asarray(g))
    assert dx_ref.dtype == BF
    xl = x_t.clone().requires_grad_(True)
    out = k4.add_pool(xl, p["graph_ptr"])
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), f32(out_ref),
                               rtol=REL, atol=1e-2 * float(
                                   np.abs(f32(out_ref)).max()))
    out.backward(torch.from_numpy(g))
    assert xl.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(xl.grad), f32(dx_ref)[:p["node_cap"]])
    assert not f32(xl.grad)[~p["mask"]].any()


def test_graph_broadcast_bf16_matches_slab_graph_broadcast():
    """B4 on a bf16 vn: the forward bit for bit (padding rows 0), its
    backward (the bf16 cotangent pooled in f32, rounded to bf16) at rtol
    2e-2."""
    rng, p = pool_setup(4, node_rows=200, d=48)
    vn_j, vn_t = bf16(rng.randn(p["graph_cap"], p["d"]))
    g_j, g_t = bf16(rng.randn(p["node_cap"], p["d"]))
    m = p["meta"]

    def ref(v):
        return slab_graph_broadcast(
            v, jnp.asarray(m["recv_local"]), jnp.asarray(m["fb"]),
            p["graph_cap"], m["block_g"], m["block_e"],
            True)[:p["node_cap"]]

    out_ref, vjp = jax.vjp(ref, vn_j)
    (dvn_ref,) = vjp(g_j)
    assert out_ref.dtype == BF and dvn_ref.dtype == BF
    vl = vn_t.clone().requires_grad_(True)
    out = k4.graph_broadcast(vl, p["graph_ptr"], p["node_cap"])
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(out), f32(out_ref))
    assert not f32(out)[~p["mask"]].any()
    out.backward(g_t)
    assert vl.grad.dtype == torch.bfloat16
    assert_bf16_close(vl.grad, dvn_ref, "dvn")


def test_segment_broadcast_bf16_plain_is_a_copy():
    """K4's plain version keeps g's dtype and copies its bits (odd width,
    empty segment, rows outside every segment)."""
    g = torch.randn(4, 3).to(torch.bfloat16)
    ptr = torch.tensor([2, 4, 4, 5, 7], dtype=torch.int32)
    out = k4.segment_broadcast(g, ptr, 9)
    assert out.dtype == torch.bfloat16
    want = torch.zeros(9, 3, dtype=torch.bfloat16)
    want[2:4], want[4], want[5:7] = g[0], g[2], g[3]
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# the models against the reference's bf16 models
# ---------------------------------------------------------------------------

def flat(grads):
    """All parameter gradients (name -> array) as one f32 vector."""
    return np.concatenate([np.asarray(grads[k], np.float32).ravel()
                           for k in sorted(grads)])


def cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def model_case(kind):
    """(port config kwargs, graphs, reference slab batch, port batch,
    loss name) of a small bf16 model: zinc GSN-EF at d=16, 2 layers, or
    the molhiv GNN_OGB at d=32 (hidden 64), 2 layers, dropout 0."""
    if kind == "zinc":
        graphs, d_id = make_zinc_like(NUM_GRAPHS)
        kw, y_shape, loss = zinc_kwargs(d_id), None, "L1Loss"
    else:
        graphs, d_id = make_molhiv_like(NUM_GRAPHS, seed=1)
        kw = molhiv_kwargs(d_id, num_layers=2, d_out=32, d_h=64,
                           d_out_id_embedding=32)
        y_shape, loss = (), "BCEWithLogitsLoss"
    kw["compute_dtype"] = "bfloat16"
    extra = {} if y_shape is None else {"y_shape": y_shape}
    jb = next(jax_batches(copy.deepcopy(graphs), NUM_GRAPHS, caps=CAPS,
                          y_dtype=np.float32, mxu_layout=SLAB, **extra))
    assert jb.seg_mode == "slab" and jb.pool_recv_local is not None
    tb = next(iterate_batches(graphs, NUM_GRAPHS, caps=CAPS,
                              y_dtype=np.float32, **extra)).to("cpu")
    return kw, graphs, jb, tb, loss


@pytest.fixture(scope="module", params=["zinc", "molhiv"])
def case(request):
    kw, graphs, jb, tb, loss = model_case(request.param)
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), jb, train=False)
    return dict(kind=request.param, kw=kw, graphs=graphs, jb=jb, tb=tb,
                loss=loss, jm=jm, v=v)


def bridged(case, **over):
    model = build_model(GSNConfig(**{**case["kw"], **over}))
    load_flax_variables(model, numpy_tree(case["v"]["params"]),
                        numpy_tree(case["v"]["batch_stats"]))
    return model


def rel_close(got, want, what):
    got, want = f32(got), f32(want)
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * float(np.abs(want).max()),
                               err_msg=what)


def test_model_eval_prediction_matches(case):
    model = bridged(case).eval()
    with torch.no_grad():
        got = model(case["tb"])
    assert got.dtype == torch.float32
    rel_close(got, case["jm"].apply(case["v"], case["jb"]), "eval")


def test_model_train_loss_gradients_and_stats_match(case):
    """Training forward: prediction and loss rel 2e-2, the all-parameter
    gradient cosine > 0.99, the running BN statistics rtol 2e-2."""
    jm, v, jb, tb = case["jm"], case["v"], case["jb"], case["tb"]
    jloss_fn = jax_metrics.LOSSES[case["loss"]]

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return jloss_fn(out, jb.y, jb.graph_mask), (out, mutated)

    (jl, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])
    model = bridged(case).train()
    out = model(tb)
    tl = metrics.LOSSES[case["loss"]](out, tb.y, tb.graph_mask)
    tl.backward()
    rel_close(out, jout, "train prediction")
    assert tl.item() == pytest.approx(float(jl), rel=REL)
    want = flax_to_state_dict(numpy_tree(jgrads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert cosine(flat(got), flat(want)) > 0.99
    state = model.state_dict()
    for name, ref in flax_to_state_dict(
            {}, numpy_tree(mutated["batch_stats"])).items():
        rel_close(state[name], ref, name)


def test_port_bf16_close_to_port_f32(case):
    """The port against itself in f32 on the same weights, as
    tests/test_compute_dtype.py holds the reference: loss rel 2e-2,
    gradient cosine > 0.99."""
    losses, grads = {}, {}
    for dt in ("bfloat16", None):
        model = bridged(case, compute_dtype=dt).train()
        tb = case["tb"]
        tl = metrics.LOSSES[case["loss"]](model(tb), tb.y, tb.graph_mask)
        tl.backward()
        losses[dt] = tl.item()
        grads[dt] = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert losses["bfloat16"] == pytest.approx(losses[None], rel=REL,
                                               abs=REL)
    assert cosine(flat(grads["bfloat16"]), flat(grads[None])) > 0.99


def test_trainer_bf16_losses_match(case):
    """Three Trainer.train_steps (Adam lr 1e-3, dropout 0) in both
    packages from the same bridged weights: losses rel 2e-2."""
    tkw = dict(lr=1e-3, batch_size=NUM_GRAPHS, scheduler="None",
               loss_fn=case["loss"], prediction_fn="None")
    jt = jax_loop.Trainer(JaxConfig(**case["kw"]),
                          jax_loop.TrainerConfig(shuffle=False, **tkw),
                          case["graphs"])
    jstate = jt.init_state(case["jb"], seed=0)
    init = jstate
    key = jax.random.PRNGKey(0)
    jlosses = []
    for _ in range(3):
        jstate, jl = jt._jit_train_step(jstate, case["jb"], 1e-3, key)
        jlosses.append(float(jl))
    tt = loop.Trainer(GSNConfig(**case["kw"]), loop.TrainerConfig(**tkw),
                      case["graphs"], device="cpu")
    tstate = tt.init_state(seed=0)
    load_flax_variables(tstate.model, numpy_tree(init.params),
                        numpy_tree(init.batch_stats))
    tlosses = []
    for _ in range(3):
        tstate, tl = tt.train_step(tstate, case["tb"])
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=REL)
    assert all(p.dtype == torch.float32
               for p in tstate.model.parameters())


# ---------------------------------------------------------------------------
# dtype pins
# ---------------------------------------------------------------------------

def test_dtypes_through_the_model(case):
    """Node rows leave every layer in bf16, pooled rows reach the head in
    f32, and the prediction is f32."""
    model = bridged(case).train()
    seen = {}

    def record(name, t):
        seen.setdefault(name, set()).add(t.dtype)

    L = len(model.cfg.d_out)
    for i in range(L):
        getattr(model, f"conv_{i}").register_forward_hook(
            lambda m, a, out, i=i: record(f"conv_{i}", out))
    heads = ([f"lin_proj_{i}" for i in range(L + 1)
              if hasattr(model, f"lin_proj_{i}")]
             if case["kind"] == "zinc" else ["lin_proj"])
    for name in heads:
        getattr(model, name).register_forward_pre_hook(
            lambda m, a, name=name: record(name, a[0]))
    out = model(case["tb"])
    assert out.dtype == torch.float32
    assert all(seen[f"conv_{i}"] == {torch.bfloat16} for i in range(L))
    assert all(seen[h] == {torch.float32} for h in heads)


def test_bn_mlp_general_bf16_routes_through_id_sq(monkeypatch):
    """general messages with bn_mlp in bf16 take the reference's fused-BN
    path: in training each layer's message runs the id_sq moments pass
    on bf16 data, then relu on the folded inputs; the prediction is
    finite f32 (tests/test_torch_fused_bn.py holds it to the
    reference)."""
    graphs, d_id = make_zinc_like(4)
    tb = next(iterate_batches(graphs, 4, y_dtype=np.float32)).to("cpu")
    model = build_model(GSNConfig(**{**zinc_kwargs(d_id), "bn_mlp": True,
                                     "compute_dtype": "bfloat16"})).train()
    calls = []
    real = filters.edge_message_aggregate
    monkeypatch.setattr(filters, "edge_message_aggregate",
                        lambda *a: calls.append((a[-1], a[1].dtype))
                        or real(*a))
    out = model(tb)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert calls == [("id_sq", torch.bfloat16),
                     ("relu", torch.bfloat16)] * len(model.cfg.d_out)


@pytest.mark.parametrize("kind", ["zinc", "molhiv"])
def test_other_compute_dtypes_raise(kind):
    kw = (zinc_kwargs([3]) if kind == "zinc" else molhiv_kwargs([3]))
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model(GSNConfig(**kw, compute_dtype="float16"))
