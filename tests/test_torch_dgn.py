"""The port's DGN slice against the reference package on the CPU: the
plain versions of the B5/B6/B8 kernels (``ops/cuda/slab_weighted.py``,
``ops/cuda/slab_minmax.py``) and B7's tie counts, the batch's vector
fields, the data helpers, ``DGNNet`` through the weight bridge on both
of the reference's layouts, the trainer, and ``NodeDropout``.

The reference kernels run in Pallas interpret mode, as its own tests run
them here.  Tolerances:

- against the reference's slab kernels, whose f32 weighted sums are a
  three-pass bf16 split (about 2^-16 relative): forward rtol 1e-3 /
  atol 1e-4, gradients rtol 5e-3 / atol 5e-4 * max|g|, the reference's
  own slab-vs-plain tolerances (tests/test_dgn.py:222, 237-238);
- against the reference's minmax kernel and its plain layout, where both
  sides are exact f32: forward rtol 2e-4 / atol 2e-5, gradients rtol
  2e-3 / atol 1e-4 * max|g| (the port's kernel tolerances); tie counts
  exact;
- loss trajectories rtol 1e-3.
"""

import copy
import sys
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsn_tpu.data import directional as jax_directional
from gsn_tpu.graphs.batching import iterate_batches as jax_batches
from gsn_tpu.nn import dgn as jax_dgn
from gsn_tpu.nn.embedding import DiscreteEmbedding as JaxEmbedding
from gsn_tpu.ops.pallas.slab_minmax import _fwd as jax_minmax_fwd
from gsn_tpu.ops.pallas.slab_minmax import slab_segment_minmax
from gsn_tpu.ops.pallas.slab_weighted import (slab_dgn_fused,
                                              slab_weighted_gather)
from gsn_tpu.ops.segment import masked_segment_max as jax_segment_max
from gsn_tpu.train import loop as jax_loop
from gsn_tpu_torch.data import directional
from gsn_tpu_torch.data.synthetic import make_dgn_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.nn import dgn
from gsn_tpu_torch.nn.embedding import DiscreteEmbedding
from gsn_tpu_torch.nn.models import NodeDropout
from gsn_tpu_torch.ops.cuda import slab_combine as k3
from gsn_tpu_torch.ops.cuda import slab_message as k12
from gsn_tpu_torch.ops.cuda import slab_minmax as b6
from gsn_tpu_torch.ops.cuda import slab_weighted as b58
from gsn_tpu_torch.ops.segment import masked_segment_max
from gsn_tpu_torch.params import flax_to_state_dict, load_flax_variables
from gsn_tpu_torch.train import loop

from test_dgn import _mol_like_graphs
from test_slab_message import BE, BN
from test_slab_message import setup as slab_setup

EXACT = dict(rtol=2e-4, atol=2e-5)
SLAB_FWD = dict(rtol=1e-3, atol=1e-4)
SLAB = {"mode": "slab", "flow": "source_to_target",
        "block_n": 128, "block_e": 256}
CAPS = (768, 2048, 48)


def grads_close(got, want, rtol, atol_scale, err_msg=""):
    atol = atol_scale * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def csr(keys, num_segments):
    ptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=num_segments), out=ptr[1:])
    return torch.from_numpy(ptr.astype(np.int32))


# ---------------------------------------------------------------------------
# B5, B6, B7, B8: the plain versions against the slab kernels
# ---------------------------------------------------------------------------

def kernel_case(K, e_pad, d=24):
    """A slab-layout edge set (tests/test_slab_message.py) with rows of
    small integers and zeros, so column maxima tie, and weights [E, K]
    zero on padding slots."""
    s = slab_setup(seed=K + e_pad, d1=d, with_pe=False, e_pad=e_pad)
    rng = np.random.RandomState(K)
    N, E = s["N"], s["E"]
    B = (np.maximum(rng.randint(-3, 4, (N, d)), 0) * 0.5).astype(np.float32)
    W = rng.rand(len(s["mask"]), K).astype(np.float32) * s["mask"][:, None]
    send = s["send"].astype(np.int32)
    seg = k12.EdgeSegments(csr(s["recv"], N), t(send), csr(send, N),
                           t(np.argsort(send, kind="stable")
                             .astype(np.int32)))
    meta = (jnp.asarray(s["meta"]["recv_local"]),
            jnp.asarray(s["meta"]["send_local"]), jnp.asarray(s["fb_wf"]),
            N, s["num_nodes"], BN, BE, True, s["meta"]["s_s"], "float32")
    return dict(s=s, N=N, E=E, B=B, W=W, seg=seg, meta=meta,
                g_w=rng.randn(s["num_nodes"], K * d).astype(np.float32),
                g_mm=rng.randn(s["num_nodes"], 2 * d).astype(np.float32))


def port_grads(fn, c, with_w, cots=("g_w", "g_mm")):
    """(outputs, dB, dW) through the port's autograd Function, with the
    named cotangents of its outputs."""
    B = t(c["B"]).requires_grad_(True)
    W = t(c["W"][:c["E"]]).requires_grad_(with_w)
    outs = fn(B, W, c["seg"])
    sum((o * t(c[g][:c["N"]])).sum() for o, g in zip(outs, cots)).backward()
    return ([o.detach().numpy() for o in outs], B.grad.numpy(),
            W.grad.numpy() if with_w else None)


@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("e_pad", [0, 300])
def test_weighted_gather_matches_slab_kernel(K, e_pad):
    """B5: forward, dB and dW against slab_weighted_gather."""
    c = kernel_case(K, e_pad)

    def ref(B, W):
        return slab_weighted_gather(B, W, *c["meta"])

    args = (jnp.asarray(c["B"]), jnp.asarray(c["W"]))
    want = np.asarray(ref(*args))
    gB, gW = jax.grad(lambda *a: jnp.sum(ref(*a) * c["g_w"]),
                      argnums=(0, 1))(*args)
    (out,), dB, dW = port_grads(
        lambda B, W, seg: (b58.weighted_gather(B, W, seg),), c, True,
        ("g_w",))
    np.testing.assert_allclose(out, want[:c["N"]], **SLAB_FWD)
    grads_close(dB, np.asarray(gB), 5e-3, 5e-4, "dB")
    grads_close(dW, np.asarray(gW)[:c["E"]], 5e-3, 5e-4, "dW")


@pytest.mark.parametrize("e_pad", [0, 300])
def test_segment_minmax_matches_slab_kernel(e_pad):
    """B6: [max, -min] and dB (even tie split) against
    slab_segment_minmax; the minmax-only branch passes no ``kc``, so the
    reference combines on the XLA path, in the slab dtype (compared after
    a cast to f32)."""
    c = kernel_case(3, e_pad)

    def ref(B):
        return slab_segment_minmax(B, *c["meta"])

    B = jnp.asarray(c["B"])
    want = np.asarray(ref(B), np.float32)
    gB = jax.grad(lambda b: jnp.sum(ref(b) * c["g_mm"]))(B)
    (mm,), dB, _ = port_grads(
        lambda B, W, seg: (b6.segment_minmax(B, seg),), c, False,
        ("g_mm",))
    np.testing.assert_allclose(mm, want[:c["N"]], **EXACT)
    grads_close(dB, np.asarray(gB), 2e-3, 1e-4, "dB")


def test_tie_counts_match_jax_combine():
    """B7's function: the port's per-column tie counts equal the ``cnt``
    residual the reference's minmax forward combines from its chunks,
    and ties do occur."""
    c = kernel_case(2, 300)
    m = c["meta"]
    _, res = jax_minmax_fwd(jnp.asarray(c["B"]), m[0], m[1], m[2], m[4],
                            m[5], m[6], m[7], m[8], m[9])
    raw, cnt = np.asarray(res[-2]), np.asarray(res[-1])
    seg = c["seg"]
    mm, got = b6.segment_minmax_fwd(t(c["B"]), seg.recv_ptr, seg.send)
    np.testing.assert_array_equal(got.numpy(), cnt[:c["N"]])
    assert (got.numpy() > 1).any()
    has_edges = (seg.recv_ptr.diff() > 0).numpy()
    np.testing.assert_array_equal(mm.numpy()[has_edges],
                                  raw[:c["N"]][has_edges])


@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("e_pad", [0, 300])
def test_dgn_fused_matches_slab_kernel(K, e_pad):
    """B8: both outputs, dB and dW against slab_dgn_fused."""
    c = kernel_case(K, e_pad)

    def ref(B, W):
        return slab_dgn_fused(B, W, *c["meta"])

    def loss(B, W):
        w_out, mm = ref(B, W)
        return jnp.sum(w_out * c["g_w"]) + jnp.sum(mm * c["g_mm"])

    args = (jnp.asarray(c["B"]), jnp.asarray(c["W"]))
    w_want, mm_want = (np.asarray(a) for a in ref(*args))
    gB, gW = jax.grad(loss, argnums=(0, 1))(*args)
    (out, mm), dB, dW = port_grads(b58.dgn_fused, c, True)
    np.testing.assert_allclose(out, w_want[:c["N"]], **SLAB_FWD)
    np.testing.assert_allclose(mm, mm_want[:c["N"]], **EXACT)
    grads_close(dB, np.asarray(gB), 5e-3, 5e-4, "dB")
    grads_close(dW, np.asarray(gW)[:c["E"]], 5e-3, 5e-4, "dW")


def test_fused_plain_is_the_two_standalone_plains():
    """B8's plain version computes exactly B5's and B6's."""
    c = kernel_case(4, 0)
    seg, B, W = c["seg"], t(c["B"]), t(c["W"][:c["E"]])
    out, mm, cnt = b58.dgn_fused_fwd(B, W, seg.recv_ptr, seg.send)
    assert torch.equal(out, b58.weighted_gather_fwd(B, W, seg.recv_ptr,
                                                    seg.send))
    mm1, cnt1 = b6.segment_minmax_fwd(B, seg.recv_ptr, seg.send)
    assert torch.equal(mm, mm1) and torch.equal(cnt, cnt1)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    c = kernel_case(2, 0)
    seg, B, W = c["seg"], t(c["B"]), t(c["W"][:c["E"]])
    wrappers = (b58.weighted_gather_fwd, b58.weighted_gather_bwd,
                b6.segment_minmax_fwd, b6.segment_minmax_bwd,
                b58.dgn_fused_fwd, b58.dgn_fused_bwd)
    before = [w.launches for w in wrappers]
    out = b58.weighted_gather(B.requires_grad_(True), W, seg)
    mm = b6.segment_minmax(B, seg)
    o2, mm2 = b58.dgn_fused(B, W, seg)
    (out.sum() + mm.sum() + o2.sum() + mm2.sum()).backward()
    assert [w.launches for w in wrappers] == before
    meta = torch.zeros(3, 4, device="meta")
    ptr = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        b6.segment_minmax_fwd(meta, ptr, ptr[:2])
    with pytest.raises(ValueError, match="no kernel"):
        b58.dgn_fused_fwd(meta, meta, ptr, ptr[:2])


# ---------------------------------------------------------------------------
# segment ops and aggregators
# ---------------------------------------------------------------------------

def test_masked_segment_max_matches():
    rng = np.random.RandomState(0)
    data = rng.randint(-3, 3, (40, 5)).astype(np.float32)
    ids = rng.randint(0, 12, 40)
    mask = rng.rand(40) > 0.3
    want = np.asarray(jax_segment_max(jnp.asarray(data), jnp.asarray(ids),
                                      14, jnp.asarray(mask)))
    got = masked_segment_max(t(data), t(ids), 14, t(mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", [
    "mean", "sum", "max", "min", "var", "std", "dir0-av", "dir1-dx",
    "dir1-dx-no-abs", "dir0-dx-balanced", "dir1-0.1", "dir0-neg-0.5"])
def test_dgn_aggregate_matches(name):
    """Each aggregator as plain segment ops, padding edges masked."""
    rng = np.random.RandomState(3)
    n, e, d = 9, 40, 5
    h_in = rng.randn(n, d).astype(np.float32)
    src, dst = rng.randint(0, n, e), rng.randint(0, n - 1, e)
    vf = rng.randn(e, 2).astype(np.float32)
    mask = rng.rand(e) > 0.2
    want = np.asarray(jax_dgn.dgn_aggregate(
        name, jnp.asarray(h_in[src]), jnp.asarray(vf), jnp.asarray(h_in),
        jnp.asarray(dst), n, jnp.asarray(mask)))
    got = dgn.dgn_aggregate(name, t(h_in[src]), t(vf), t(h_in), t(dst), n,
                            t(mask))
    np.testing.assert_allclose(got.numpy(), want, **EXACT)


def test_scalers_and_avg_d_match():
    graphs = _mol_like_graphs(num=6, seed=2)
    assert dgn.compute_avg_d(graphs) == jax_dgn.compute_avg_d(graphs)
    h = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    deg = np.array([0.0, 1.0, 2.0, 5.0], np.float32)
    for name in ("identity", "amplification", "attenuation"):
        want = jax_dgn.dgn_scale(name, jnp.asarray(h), jnp.asarray(deg),
                                 {"log": 1.3})
        got = dgn.dgn_scale(name, t(h), t(deg), {"log": 1.3})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("directions", [("subgraphs",), ("eig",),
                                        ("eig", "subgraphs", "edge_feat")])
def test_assemble_directions_matches(directions):
    graphs = _mol_like_graphs(num=10, seed=4)
    for g in graphs:
        g["edge_features"] = np.ones((g["edge_index"].shape[1], 2))
    graphs[0] = dict(graphs[0], x=graphs[0]["x"][:5])   # dropped: 5 nodes
    got = directional.assemble_directions(copy.deepcopy(graphs),
                                          directions, id_scope="local")
    want = jax_directional.assemble_directions(graphs, directions,
                                               id_scope="local")
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in ("node_eig", "edge_eig"):
            if key in b:
                np.testing.assert_array_equal(a[key], b[key])


def test_make_dgn_like_matches_bench():
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import bench
    got = make_dgn_like(12, seed=3)
    want = bench.make_dgn_like(12, seed=3)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in ("x", "edge_index", "edge_eig", "identifiers",
                    "degrees", "y"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def dgn_graphs(num=48, seed=3):
    graphs = _mol_like_graphs(num=num, seed=seed)
    return jax_directional.assemble_directions(
        graphs, directions=("eig", "subgraphs"), id_scope="local")


def test_batch_vector_fields_match_jax_batch():
    """The port's real edges carry the same (dst, src, edge_eig) triples
    as the reference's plain batch, and in the same order as its slab
    layout (both sort real edges stably by receiver); node_eig is the
    same array."""
    graphs = dgn_graphs(num=24, seed=5)
    plain = next(jax_batches(graphs, 24, caps=CAPS, y_shape=(),
                             y_dtype=np.float32))
    slab = next(jax_batches(graphs, 24, caps=CAPS, y_shape=(),
                            y_dtype=np.float32, mxu_layout=SLAB))
    ours = next(iterate_batches(graphs, 24, caps=CAPS, y_shape=(),
                                y_dtype=np.float32))
    assert slab.seg_mode == "slab"
    e = ours.num_real_edges

    def trips(ei, eig, mask):
        return sorted(map(tuple, np.concatenate(
            [ei.T[mask][:, ::-1], eig[mask]], axis=1).tolist()))

    ours_mask = np.arange(ours.num_edge_slots) < e
    assert trips(ours.edge_index, ours.edge_eig, ours_mask) == trips(
        np.asarray(plain.edge_index), np.asarray(plain.edge_eig),
        np.asarray(plain.edge_mask))
    np.testing.assert_array_equal(ours.edge_index[:, :e],
                                  np.asarray(slab.edge_index)[:, :e])
    np.testing.assert_array_equal(ours.edge_eig[:e],
                                  np.asarray(slab.edge_eig)[:e])
    assert not ours.edge_eig[e:].any()
    np.testing.assert_array_equal(ours.node_eig, np.asarray(plain.node_eig))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

# tests/test_dgn.py:205-208, the bench_dgn set (fused branch), a
# weighted-only set with std's segment path, a minmax-only set with var;
# the last two also turn on the model's other options
AGG_SETS = {
    "reference": ("mean", "max", "min", "sum", "dir1-av", "dir1-dx",
                  "dir2-dx-no-abs", "dir0-0.1"),
    "bench": ("mean", "max", "min", "dir0-av", "dir1-av", "dir2-av",
              "dir3-av"),
    "weighted": ("mean", "sum", "dir0-av", "dir1-dx-balanced",
                 "dir2-neg-0.5", "std"),
    "minmax": ("max", "min", "var"),
}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


@pytest.fixture(scope="module")
def dgn_data():
    graphs = dgn_graphs()
    avg_d = dgn.compute_avg_d(graphs)
    plain = next(jax_batches(graphs, 48, caps=CAPS, y_shape=(),
                             y_dtype=np.float32))
    slab = next(jax_batches(graphs, 48, caps=CAPS, y_shape=(),
                            y_dtype=np.float32, mxu_layout=SLAB))
    assert slab.seg_mode == "slab"
    ours = next(iterate_batches(graphs, 48, caps=CAPS, y_shape=(),
                                y_dtype=np.float32)).to("cpu")
    return dict(graphs=graphs, avg_d=avg_d, plain=plain, slab=slab,
                ours=ours)


OPTIONS = {
    "weighted": dict(graph_norm=True, pos_enc_dim=2, readout="sum"),
    "minmax": dict(scalers=("identity", "amplification", "attenuation"),
                   posttrans_layers=2, readout="max"),
}


def configs(aggs, avg_d, **options):
    kw = dict(hidden_dim=32, out_dim=32, num_layers=2, aggregators=aggs,
              avg_d=avg_d, dropout=0.0, **options)
    return jax_dgn.DGNConfig(**kw), dgn.DGNConfig(**kw)


@pytest.mark.parametrize("layout", ["plain", "slab"])
@pytest.mark.parametrize("aggs", list(AGG_SETS))
def test_dgn_net_matches(dgn_data, aggs, layout):
    """DGNNet through the weight bridge: eval and train predictions,
    every parameter gradient of a masked loss, and the running BN
    statistics after one training forward."""
    jcfg, cfg = configs(AGG_SETS[aggs], dgn_data["avg_d"],
                        **OPTIONS.get(aggs, {}))
    jb = dgn_data[layout]
    jm = jax_dgn.DGNNet(jcfg)
    v = jm.init(jax.random.PRNGKey(0), dgn_data["plain"], train=False)
    model = dgn.DGNNet(cfg)
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    fwd = EXACT if layout == "plain" else SLAB_FWD
    rtol, scale = (2e-3, 1e-4) if layout == "plain" else (5e-3, 5e-4)
    tb = dgn_data["ours"]

    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jb)), **fwd)

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return ((out ** 2) * jb.graph_mask[:, None]).sum(), (out, mutated)

    (_, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])
    model.train()
    out = model(tb)
    ((out ** 2) * tb.graph_mask[:, None]).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **fwd)
    want = flax_to_state_dict(numpy_tree(jgrads))
    g_scale = max(float(np.max(np.abs(w))) for w in want.values())
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(grads[name], ref, rtol=rtol,
                                   atol=scale * g_scale, err_msg=name)
    state = model.state_dict()
    for name, ref in flax_to_state_dict(
            {}, numpy_tree(mutated["batch_stats"])).items():
        np.testing.assert_allclose(state[name].numpy(), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_atom_encoder_matches():
    rng = np.random.RandomState(0)
    dims = [119, 4, 12, 12, 10, 6, 6, 2, 2]
    x = np.stack([rng.randint(0, v, 30) for v in dims], 1)
    jenc = JaxEmbedding("atom_encoder", 9, None, 16)
    v = jenc.init(jax.random.PRNGKey(1), jnp.asarray(x))
    enc = DiscreteEmbedding("atom_encoder", 9, None, 16)
    load_flax_variables(enc, numpy_tree(v["params"]))
    assert enc.d_out == 16
    np.testing.assert_allclose(enc(t(x)).detach().numpy(),
                               np.asarray(jenc.apply(v, jnp.asarray(x))),
                               **EXACT)


def test_trainer_loss_trajectory_matches(dgn_data):
    """Three Trainer.train_steps of the DGN model (BCE, Adam lr 1e-3,
    dropout 0) in both packages from the same weights, after
    ``evaluate`` on the whole set."""
    graphs = dgn_data["graphs"]
    jcfg, cfg = configs(AGG_SETS["bench"], dgn_data["avg_d"])
    tkw = dict(lr=1e-3, batch_size=48, scheduler="None",
               loss_fn="BCEWithLogitsLoss", prediction_fn="None")
    jt = jax_loop.Trainer(jcfg, jax_loop.TrainerConfig(shuffle=False, **tkw),
                          graphs, model=jax_dgn.DGNNet(jcfg))
    jb = dgn_data["plain"]
    jstate = jt.init_state(jb, seed=0)
    init = jstate
    jeval = jt.evaluate(jstate, graphs)
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
    np.testing.assert_allclose(tt.evaluate(tstate, graphs)[0], jeval[0],
                               rtol=1e-3)
    tlosses = []
    for _ in range(3):
        tstate, tl = tt.train_step(tstate, dgn_data["ours"])
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)


def test_trainer_draws_fresh_seeded_weights(dgn_data):
    _, cfg = configs(AGG_SETS["minmax"], dgn_data["avg_d"])
    tt = loop.Trainer(cfg, loop.TrainerConfig(batch_size=48),
                      dgn_data["graphs"], device="cpu",
                      model=dgn.DGNNet(cfg))
    a, b, c = tt.init_state(0), tt.init_state(0), tt.init_state(1)
    wa = a.model.layer_0.posttrans.fc_0.weight
    assert a.model is not tt.model
    assert torch.equal(wa, b.model.layer_0.posttrans.fc_0.weight)
    assert not torch.equal(wa, c.model.layer_0.posttrans.fc_0.weight)


def test_node_dropout_statistics():
    """Keep share 1 - rate, kept rows scaled by 1/(1 - rate), the mask
    fixed by the generator's seed; identity in eval mode and at rate 0."""
    x = torch.ones(40000, 4)
    drop = NodeDropout(0.3).train()
    y = drop(x, torch.Generator().manual_seed(5))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(y, drop(x, torch.Generator().manual_seed(5)))
    assert not torch.equal(y, drop(x, torch.Generator().manual_seed(6)))
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(NodeDropout(0.0).train()(x), x)
