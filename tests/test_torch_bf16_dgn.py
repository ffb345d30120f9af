"""The port's DGN in bf16 (``DGNConfig.compute_dtype="bfloat16"``)
against the reference package's, on the CPU.

Both packages get the same seeded numpy inputs.  The reference runs its
B5/B6/B8 Pallas kernels with ``data_dtype="bfloat16"`` in interpret mode
and its model on the slab layout, where the kernels run; the port runs
its kernels' plain versions.  The reference rounds each chunk's partial
sums (its slabs) to bf16 before combining them, which the port, having
no chunks, does not (``ROADMAP.md`` B, "precision contract"), so:

- maxima and tie counts are exact (the reference's minmax combine keeps
  the slab dtype on this path: compared after a cast to f32);
- the weighted sums, dh and dB: rtol 2e-2 / atol 1e-2·max|want|;
- dW, an f32 sum of the same bf16 values in both: rtol 2e-3 / atol
  1e-4·max|want|;
- models (tests/test_compute_dtype.py:80-85): prediction and loss rel
  2e-2, the all-parameter gradient cosine > 0.99, BN running statistics
  rtol 2e-2 (atol 2e-2·max|want|); three trainer losses rel 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsn_tpu.nn import dgn as jax_dgn
from gsn_tpu.ops.pallas.slab_minmax import _fwd as jax_minmax_fwd
from gsn_tpu.ops.pallas.slab_minmax import slab_segment_minmax
from gsn_tpu.ops.pallas.slab_weighted import (slab_dgn_fused,
                                              slab_weighted_gather)
from gsn_tpu.train import loop as jax_loop
from gsn_tpu_torch.nn import dgn
from gsn_tpu_torch.ops.cuda import slab_minmax as b6
from gsn_tpu_torch.ops.cuda import slab_weighted as b58
from gsn_tpu_torch.params import load_flax_variables
from gsn_tpu_torch.train import loop

from test_torch_bf16 import REL, assert_bf16_close, cosine, f32, flat
from test_torch_dgn import (AGG_SETS, dgn_data,  # noqa: F401
                            grads_close, kernel_case, numpy_tree, t)

BF = jnp.bfloat16


# ---------------------------------------------------------------------------
# B5, B6, B7, B8 in bf16: the plain versions against the slab kernels
# ---------------------------------------------------------------------------

def bf16_case(K, d):
    """``kernel_case`` with padding edges, for ``data_dtype="bfloat16"``:
    its rows (halves from 0 to 1.5, tied in every column) are exact in
    bf16."""
    c = kernel_case(K, 300, d)
    c["meta"] = c["meta"][:-1] + ("bfloat16",)
    c["B_j"] = jnp.asarray(c["B"]).astype(BF)
    assert np.array_equal(np.asarray(c["B_j"].astype(jnp.float32)), c["B"])
    return c


def port_grads(fn, c, with_w, cots):
    """(outputs, dB, dW) through the port's autograd Function on bf16
    rows, with the named f32 cotangents of its outputs."""
    B = t(c["B"]).to(torch.bfloat16).requires_grad_(True)
    W = t(c["W"][:c["E"]]).requires_grad_(with_w)
    outs = fn(B, W, c["seg"])
    sum((o.float() * t(c[g][:c["N"]])).sum()
        for o, g in zip(outs, cots)).backward()
    return outs, B.grad, W.grad if with_w else None


@pytest.mark.parametrize("K,d", [(1, 24), (5, 70)])
def test_weighted_gather_bf16_matches_slab_kernel(K, d):
    """B5 on bf16 rows: the f32 weighted sums, dB (bf16) and dW (f32)."""
    c = bf16_case(K, d)

    def ref(B, W):
        return slab_weighted_gather(B, W, *c["meta"])

    W = jnp.asarray(c["W"])
    want = ref(c["B_j"], W)
    gB, gW = jax.grad(lambda *a: jnp.sum(ref(*a) * c["g_w"]),
                      argnums=(0, 1))(c["B_j"], W)
    (out,), dB, dW = port_grads(
        lambda B, W, seg: (b58.weighted_gather(B, W, seg),), c, True,
        ("g_w",))
    assert out.dtype == torch.float32 and dB.dtype == torch.bfloat16
    assert_bf16_close(out, want[:c["N"]], "forward")
    assert_bf16_close(dB, gB, "dB")
    grads_close(dW.numpy(), np.asarray(gW)[:c["E"]], 2e-3, 1e-4, "dW")


@pytest.mark.parametrize("d", [24, 70])
def test_segment_minmax_bf16_matches_slab_kernel(d):
    """B6 on bf16 rows: [max, -min] exact, dB (the even tie split of the
    f32 cotangent, rounded) at rtol 2e-2."""
    c = bf16_case(3, d)

    def ref(B):
        return slab_segment_minmax(B, *c["meta"])

    want = ref(c["B_j"])
    gB = jax.grad(lambda b: jnp.sum(ref(b).astype(jnp.float32)
                                    * c["g_mm"]))(c["B_j"])
    (mm,), dB, _ = port_grads(
        lambda B, W, seg: (b6.segment_minmax(B, seg),), c, False,
        ("g_mm",))
    assert mm.dtype == torch.float32 and dB.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(mm), f32(want)[:c["N"]])
    assert_bf16_close(dB, gB, "dB")


def test_tie_counts_bf16_match_jax_combine():
    """B7 in bf16: the port's tie counts equal the reference's combined
    ``cnt`` on bf16 slabs, and its maxima the combined maxima."""
    c = bf16_case(2, 24)
    m = c["meta"]
    _, res = jax_minmax_fwd(c["B_j"], m[0], m[1], m[2], m[4], m[5], m[6],
                            m[7], m[8], m[9])
    raw, cnt = f32(res[-2]), f32(res[-1])
    seg = c["seg"]
    mm, got = b6.segment_minmax_fwd(t(c["B"]).to(torch.bfloat16),
                                    seg.recv_ptr, seg.send)
    np.testing.assert_array_equal(got.numpy(), cnt[:c["N"]])
    assert (got.numpy() > 1).any()
    has_edges = (seg.recv_ptr.diff() > 0).numpy()
    np.testing.assert_array_equal(mm.numpy()[has_edges],
                                  raw[:c["N"]][has_edges])


@pytest.mark.parametrize("K,d", [(1, 24), (5, 70)])
def test_dgn_fused_bf16_matches_slab_kernel(K, d):
    """B8 on bf16 rows: the weighted sums, exact maxima, dB and dW."""
    c = bf16_case(K, d)

    def ref(B, W):
        return slab_dgn_fused(B, W, *c["meta"])

    def loss(B, W):
        w_out, mm = ref(B, W)
        return (jnp.sum(w_out * c["g_w"])
                + jnp.sum(mm.astype(jnp.float32) * c["g_mm"]))

    W = jnp.asarray(c["W"])
    w_want, mm_want = ref(c["B_j"], W)
    gB, gW = jax.grad(loss, argnums=(0, 1))(c["B_j"], W)
    (out, mm), dB, dW = port_grads(b58.dgn_fused, c, True, ("g_w", "g_mm"))
    assert_bf16_close(out, w_want[:c["N"]], "forward")
    np.testing.assert_array_equal(f32(mm), f32(mm_want)[:c["N"]])
    assert_bf16_close(dB, gB, "dB")
    grads_close(dW.numpy(), np.asarray(gW)[:c["E"]], 2e-3, 1e-4, "dW")


def test_bf16_rounding_points():
    """Where the bf16 mode rounds, pinned by inputs whose results differ
    by 2^-9 (below bf16's resolution near 1) whether or not a value is
    rounded: each W[e, k] is rounded in the forward's product but not in
    the backward's dh; g_w is rounded; g_mm is not; dh is the f32 sum of
    both parts, rounded once."""
    bf, eps = torch.bfloat16, 2.0 ** -9
    ptr = torch.tensor([0, 2], dtype=torch.int32)
    send = torch.tensor([0, 1], dtype=torch.int32)
    B = torch.tensor([[1.0], [-1.0]])
    W = torch.tensor([[1 + eps, 1.0], [1.0, -1.0]])
    # forward: (1 + eps)·1 + 1·(-1) is eps in f32 and 0 with W rounded
    assert b58.weighted_gather_fwd(B, W, ptr, send)[0, 0] == eps
    out = b58.weighted_gather_fwd(B.to(bf), W, ptr, send)
    assert out.dtype == torch.float32 and out[0, 0] == 0.0
    # backward, edge 0: (1 + eps)·1 + 1·(-1) = eps with W unrounded
    g_w = torch.tensor([[1.0, -1.0]])
    dh, dW = b58.weighted_gather_bwd(B.to(bf), W, g_w, ptr, send, True)
    assert dh.dtype == bf and dh[0, 0] == eps
    assert dW.dtype == torch.float32
    # g_w rounded: edge 1 has 1·(1 + eps) - 1·1, which is 0 once rounded
    dh, _ = b58.weighted_gather_bwd(B.to(bf), W,
                                    torch.tensor([[1 + eps, 1.0]]), ptr,
                                    send)
    assert dh[1, 0] == 0.0
    # g_mm not rounded: edge 0 alone attains the max of a one-edge row;
    # its dh is 1·(-1) + (1 + eps) = eps
    ptr1, send1 = torch.tensor([0, 1], dtype=torch.int32), send[:1]
    W1 = torch.tensor([[1.0]])
    mm, cnt = b6.segment_minmax_fwd(B.to(bf), ptr1, send1)
    g_mm = torch.tensor([[1 + eps, 0.0]])
    dh, _ = b58.dgn_fused_bwd(B.to(bf), W1, torch.tensor([[-1.0]]), mm, cnt,
                              g_mm, ptr1, send1)
    assert dh.dtype == bf and dh[0, 0] == eps
    # ... and the minmax part alone is rounded once: 1 + eps -> 1
    dh = b6.segment_minmax_bwd(B.to(bf), mm, cnt, g_mm, ptr1, send1)
    assert dh.dtype == bf and dh[0, 0] == 1.0


# ---------------------------------------------------------------------------
# DGNNet in bf16 against the reference's bf16 DGNNet on the slab layout
# ---------------------------------------------------------------------------

# one aggregator set per branch of the layer's kernel dispatch, and one
# with a directional derivative and std's f32 segment path
BF16_SETS = {
    "fused": AGG_SETS["bench"],
    "weighted": AGG_SETS["weighted"],
    "minmax": AGG_SETS["minmax"],
    "dx_std": ("mean", "max", "dir1-dx", "std"),
}


def configs(aggs, avg_d, compute_dtype="bfloat16", **options):
    kw = dict(hidden_dim=32, out_dim=32, num_layers=2, aggregators=aggs,
              avg_d=avg_d, dropout=0.0, compute_dtype=compute_dtype,
              **options)
    return jax_dgn.DGNConfig(**kw), dgn.DGNConfig(**kw)


def rel_close(got, want, what):
    got, want = f32(got), f32(want)
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * float(np.abs(want).max()),
                               err_msg=what)


def bridged(v, cfg):
    model = dgn.DGNNet(cfg)
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    return model


def masked_square(out, mask):
    return ((out ** 2) * mask[:, None]).sum()


def test_dgn_net_bf16_close_to_f32(dgn_data):
    """The port's bf16 DGNNet against its f32 one on the same weights:
    loss rel 2e-2, gradient cosine > 0.99."""
    losses, grads = {}, {}
    jcfg, _ = configs(BF16_SETS["fused"], dgn_data["avg_d"])
    v = jax_dgn.DGNNet(jcfg).init(jax.random.PRNGKey(1), dgn_data["plain"],
                                  train=False)
    tb = dgn_data["ours"]
    for dt in ("bfloat16", None):
        _, cfg = configs(BF16_SETS["fused"], dgn_data["avg_d"], dt)
        model = bridged(v, cfg).train()
        tl = masked_square(model(tb), tb.graph_mask)
        tl.backward()
        losses[dt] = tl.item()
        grads[dt] = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert losses["bfloat16"] == pytest.approx(losses[None], rel=REL)
    assert cosine(flat(grads["bfloat16"]), flat(grads[None])) > 0.99


def test_trainer_bf16_losses_match(dgn_data):
    """Three Trainer.train_steps of the bf16 DGN model (BCE, Adam lr
    1e-3, dropout 0) in both packages from the same weights, the
    reference on the slab layout: losses rel 2e-2."""
    graphs = dgn_data["graphs"]
    jcfg, cfg = configs(BF16_SETS["fused"], dgn_data["avg_d"])
    tkw = dict(lr=1e-3, batch_size=48, scheduler="None",
               loss_fn="BCEWithLogitsLoss", prediction_fn="None")
    jt = jax_loop.Trainer(jcfg, jax_loop.TrainerConfig(shuffle=False, **tkw),
                          graphs, model=jax_dgn.DGNNet(jcfg))
    jb = dgn_data["slab"]
    jstate = jt.init_state(jb, seed=0)
    init = jstate
    key = jax.random.PRNGKey(0)
    jlosses = []
    for _ in range(3):
        jstate, jl = jt._jit_train_step(jstate, jb, 1e-3, key)
        jlosses.append(float(jl))
    tt = loop.Trainer(cfg, loop.TrainerConfig(**tkw), graphs, device="cpu",
                      model=dgn.DGNNet(cfg))
    tstate = tt.init_state(seed=0)
    load_flax_variables(tstate.model, numpy_tree(init.params),
                        numpy_tree(init.batch_stats))
    tlosses = []
    for _ in range(3):
        tstate, tl = tt.train_step(tstate, dgn_data["ours"])
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=REL)
    assert all(p.dtype == torch.float32
               for p in tstate.model.parameters())


def test_dgn_bf16_dtypes(dgn_data, monkeypatch):
    """Node rows leave every layer in bf16, the readout head gets f32
    rows, the prediction and the parameters are f32, and the kernels
    take the rows in bf16; float16 raises."""
    _, cfg = configs(BF16_SETS["fused"], dgn_data["avg_d"])
    model = dgn.build_dgn_model(cfg, torch.Generator().manual_seed(0))
    seen = {}

    def record(name, x):
        seen.setdefault(name, set()).add(x.dtype)

    for i in range(cfg.num_layers):
        getattr(model, f"layer_{i}").register_forward_hook(
            lambda m, a, out, i=i: record(f"layer_{i}", out))
    model.readout_fc_0.register_forward_pre_hook(
        lambda m, a: record("readout", a[0]))
    kernel_rows, fused = [], dgn.dgn_fused
    monkeypatch.setattr(dgn, "dgn_fused", lambda B, W, seg: (
        kernel_rows.append((B.dtype, W.dtype)) or fused(B, W, seg)))
    out = model(dgn_data["ours"])
    assert kernel_rows == [(torch.bfloat16, torch.float32)] * cfg.num_layers
    assert out.dtype == torch.float32
    assert all(seen[f"layer_{i}"] == {torch.bfloat16}
               for i in range(cfg.num_layers))
    assert seen["readout"] == {torch.float32}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        dgn.DGNNet(configs(BF16_SETS["fused"], dgn_data["avg_d"],
                           "float16")[1])
