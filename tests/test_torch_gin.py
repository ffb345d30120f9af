"""The port's ``gin`` message kind against the reference package on the
CPU: ``GSNLayer(msg_kind="gin")`` (local and global ids, with and
without edge features, ``extend_dims`` on and off, a learned ε or none,
one-hot and embedding id kinds), and the README's IMDBBINARY model
(``GSN_sparse``, gin, local ``complete_graph`` counts, one-hot ids,
mean readout) at a small size with a layer-0 width of 1, in f32 and in
bf16.

Inputs are seeded numpy; weights come from the reference's flax tree
through ``params.py``.  The port's kernel path runs K1/K2's plain
versions (one identity-mode call a part, the edge parts with a zero B);
the reference runs its slab kernels in interpret mode on the slab
layout, and plain XLA on the plain layout.  Tolerances: forward rtol
2e-4 / atol 2e-5, gradients rtol 2e-3 / atol 1e-4 * max|g|, BN
statistics rtol 1e-4 / atol 1e-5 (tests/test_mxu_integration.py:48,
79-84); bf16 loss rel 2e-2 and gradient cosine > 0.99
(tests/test_compute_dtype.py:80-85).
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
from gsn_tpu.nn.filters import GSNLayer as JaxLayer
from gsn_tpu.nn.models import build_model as jax_build_model
from gsn_tpu.train import metrics as jax_metrics
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.encoding import encode
from gsn_tpu_torch.data.pipeline import generate_dataset
from gsn_tpu_torch.data.synthetic import make_imdb_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.graphs.patterns import complete_graph
from gsn_tpu_torch.nn.filters import GSNLayer
from gsn_tpu_torch.nn.models import build_model, edge_segments
from gsn_tpu_torch.ops.cuda import slab_message as k12
from gsn_tpu_torch.params import flax_to_state_dict, load_flax_variables
from gsn_tpu_torch.train import metrics

FWD = dict(rtol=2e-4, atol=2e-5)
SLAB = {"mode": "slab", "flow": "source_to_target",
        "block_n": 128, "block_e": 256}
CAPS = (1024, 4096, 256)
NUM_GRAPHS = 16
D = 12


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def grads_close(got, want):
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


def imdb_graphs(num, seed, max_nodes=40):
    """``make_imdb_like`` ego-networks of at most ``max_nodes`` nodes as
    the TU loader's graph dicts (one node tag: x is one column of
    ones)."""
    out = []
    for n, edges, label in make_imdb_like(4 * num, seed):
        if n > max_nodes:
            continue
        und = np.array(edges, np.int64).T
        out.append({"x": np.ones((n, 1), np.float32),
                    "edge_index": np.concatenate([und, und[::-1]], 1),
                    "y": np.int64(label)})
        if len(out) == num:
            return out
    raise AssertionError("too few small graphs")


def counted_imdb(num, seed, k=4):
    """``imdb_graphs`` with local non-induced ``complete_graph`` counts
    for k=3..``k``, one-hot-unique encoded: (graphs, per-column id
    vocabulary)."""
    graphs, _ = generate_dataset(imdb_graphs(num, seed),
                                 [complete_graph(j) for j in range(3, k + 1)],
                                 id_scope="local", induced=False)
    graphs, _eid, d_id, _ed, _dd = encode(graphs, "one_hot_unique")
    return graphs, d_id


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def layer_graphs(scope, num=NUM_GRAPHS, seed=3):
    """Ego-networks whose node rows, ids and edge features are float rows
    of width D."""
    rng = np.random.RandomState(seed)
    out = []
    for g in imdb_graphs(num, seed):
        n, e = g["x"].shape[0], g["edge_index"].shape[1]
        out.append({
            "x": rng.randn(n, D).astype(np.float32),
            "edge_index": g["edge_index"],
            "degrees": np.zeros(n, np.float32),
            "identifiers": rng.randn(n if scope == "global" else e,
                                     D).astype(np.float32),
            "ids_on_edges": scope == "local",
            "edge_features": rng.randn(e, D).astype(np.float32),
            "y": g["y"]})
    return out


# (id scope, edge features, extend_dims, train_eps, id kind)
LAYER_CASES = {
    "local_ef_extend_eps": ("local", True, True, True, "one_hot_encoder"),
    "local_noextend": ("local", False, False, False, "one_hot_encoder"),
    "local_embedding": ("local", True, True, False, "embedding"),
    "global_ef_noextend_eps": ("global", True, False, True,
                               "one_hot_encoder"),
    "global": ("global", False, True, False, "one_hot_encoder"),
}


@pytest.mark.parametrize("path,layout", [("kernel", "slab"),
                                         ("kernel", "plain"),
                                         ("per_edge", "plain")])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_gin_layer_matches(case, path, layout):
    """GSNLayer(msg_kind='gin') in train mode: real node rows, every
    parameter gradient (ε and the central rows among them) of a masked
    loss, and the update MLP's BN statistics; the port's kernel path
    (K1/K2's plain versions) against both reference layouts, its
    per-edge path against the plain layout."""
    scope, ef, extend, eps, kind = LAYER_CASES[case]
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
    kw = dict(msg_kind="gin", id_scope=scope, use_ids=True,
              use_edge_features=ef, flow="source_to_target",
              activation_mlp="relu", bn_mlp=True, train_eps=eps,
              id_embedding_kind=kind, edge_embedding_kind="embedding",
              extend_dims=extend)
    jl = JaxLayer(d_up=D, d_h=(2 * D,), **kw)
    args = (jnp.asarray(jb.x), jb.edge_index, jb.identifiers, None,
            jb.edge_features, jb.node_mask, jb.edge_mask)
    v = jl.init(jax.random.PRNGKey(0), *args, False, seg=seg)
    if eps:   # a nonzero ε, so (1+ε) is exercised
        v = flax.core.unfreeze(v)
        v["params"]["eps"] = jnp.float32(0.25)
    mask = np.asarray(jb.node_mask)
    w = np.random.RandomState(5).randn(mask.shape[0], D).astype(np.float32)
    w *= mask[:, None]

    def loss(params):
        out, mutated = jl.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, *args,
            True, seg=seg, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mutated)

    (_, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])

    layer = GSNLayer(D, D, None, (2 * D,), d_id=D, d_ef=D, **kw).train()
    load_flax_variables(layer, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    assert hasattr(layer, "eps") == eps
    out = layer(tb.x, tb.edge_index, tb.identifiers, None, tb.edge_features,
                tb.node_mask, tb.edge_mask,
                edge_segments(tb) if path == "kernel" else None)
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[mask],
                               np.asarray(jout)[mask], **FWD)
    grads_close({n: p.grad.numpy() for n, p in layer.named_parameters()},
                flax_to_state_dict(numpy_tree(jgrads)))
    stats_close(layer, mutated)


def test_gin_kernel_path_calls_k1_per_part(monkeypatch):
    """With ids and edge features at local scope the kernel path makes
    three identity-mode calls: x as B, then each edge part as Pe with a
    zero B of the sender rows, each with no A side and a zero b1."""
    graphs = layer_graphs("local", num=4)
    tb = next(iterate_batches(graphs, 4, y_dtype=np.float32)).to("cpu")
    calls = []
    real = k12.edge_message_aggregate

    def spy(A, B, Pe, b1, seg, act):
        calls.append((A, B.clone(), Pe, b1.clone(), act))
        return real(A, B, Pe, b1, seg, act)

    monkeypatch.setattr("gsn_tpu_torch.nn.filters.edge_message_aggregate",
                        spy)
    layer = GSNLayer(D, D, None, (D,), msg_kind="gin", id_scope="local",
                     use_ids=True, use_edge_features=True, d_id=D, d_ef=D)
    out = layer(tb.x, tb.edge_index, tb.identifiers, None, tb.edge_features,
                tb.node_mask, tb.edge_mask, edge_segments(tb))
    assert out.shape == (tb.x.shape[0], D)
    assert [c[4] for c in calls] == ["identity"] * 3
    assert all(c[0] is None and not c[3].any() for c in calls)
    torch.testing.assert_close(calls[0][1], tb.x)
    assert calls[0][2] is None
    for A, B, Pe, _b1, _act in calls[1:]:
        assert not B.any() and B.shape[1] == D + 1
        assert Pe.shape == (tb.edge_index.shape[1], D + 1)


# ---------------------------------------------------------------------------
# the README's IMDBBINARY model
# ---------------------------------------------------------------------------

def imdb_kwargs(d_id, **over):
    """README.md's IMDBBINARY command (--id_type complete_graph --k 5
    --id_scope local --id_encoding one_hot_unique --id_embedding
    one_hot_encoder --model_name GSN_sparse --msg_kind gin --num_layers 4
    --d_out 64 --final_projection True --readout mean) at d_out 8 and 3
    layers, with the CLI's defaults for the rest (bn, bn_mlp, 2-layer
    MLPs, relu); x is the one node tag's column."""
    kw = dict(model_name="GSN_sparse", msg_kind="gin", num_layers=3,
              d_out=8, out_features=2, id_scope="local",
              id_embedding="one_hot_encoder", final_projection=[True],
              readout="mean", bn=True, bn_mlp=True, in_features=1,
              d_in_node_encoder=[1], d_in_id=d_id,
              flow="source_to_target")
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def imdb():
    graphs, d_id = counted_imdb(NUM_GRAPHS, seed=2)
    out = dict(graphs=graphs, d_id=d_id)
    for layout in ("plain", "slab"):
        out[layout] = next(jax_batches(
            copy.deepcopy(graphs), NUM_GRAPHS, caps=CAPS,
            mxu_layout=SLAB if layout == "slab" else None))
    assert out["slab"].seg_mode == "slab"
    out["ours"] = next(iterate_batches(graphs, NUM_GRAPHS,
                                       caps=CAPS)).to("cpu")
    assert out["ours"].x.shape[1] == 1
    return out


@pytest.mark.parametrize("layout", ["plain", "slab"])
def test_imdb_model_matches(imdb, layout):
    """The IMDB model through the weight bridge: its layer-0 node part is
    1 wide and its edge part sum(d_id) + 1; eval prediction,
    training loss, every parameter gradient and every running BN
    statistic after one training forward."""
    kw = imdb_kwargs(imdb["d_id"])
    jb = imdb[layout]
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), imdb["plain"], train=False)
    model = build_model(GSNConfig(**kw))
    assert model.conv_0.central_id.d_out == sum(imdb["d_id"]) + 1
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    tb = imdb["ours"]
    gm = np.asarray(jb.graph_mask)
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(tb).numpy()[gm],
                                   np.asarray(jm.apply(v, jb))[gm], **FWD)

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return jax_metrics.cross_entropy_loss(out, jb.y, jb.graph_mask), \
            mutated

    (jloss, mutated), jgrads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    model.train()
    tloss = metrics.cross_entropy_loss(model(tb), tb.y, tb.graph_mask)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **FWD)
    grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                flax_to_state_dict(numpy_tree(jgrads)))
    stats_close(model, mutated)


def flat(grads):
    return np.concatenate([np.ravel(g) for _, g in sorted(grads.items())])


def test_imdb_model_bf16_matches(imdb):
    """The IMDB model with compute_dtype='bfloat16' against the
    reference's on the slab layout: loss rel 2e-2, the all-parameter
    gradient cosine > 0.99."""
    kw = imdb_kwargs(imdb["d_id"], compute_dtype="bfloat16")
    jb = imdb["slab"]
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), imdb["plain"], train=False)
    model = build_model(GSNConfig(**kw))
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))

    def loss(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                       jb, train=True, mutable=["batch_stats"])[0]
        return jax_metrics.cross_entropy_loss(out, jb.y, jb.graph_mask)

    jloss, jgrads = jax.value_and_grad(loss)(v["params"])
    model.train()
    tb = imdb["ours"]
    tloss = metrics.cross_entropy_loss(model(tb), tb.y, tb.graph_mask)
    tloss.backward()
    assert abs(float(tloss) - float(jloss)) <= 2e-2 * abs(float(jloss))
    got = flat({n: p.grad.numpy() for n, p in model.named_parameters()})
    want = flat(flax_to_state_dict(numpy_tree(jgrads)))
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.99
