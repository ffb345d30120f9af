"""The port's remaining GSN variants against the reference package on the
CPU: every encoder kind of ``DiscreteEmbedding`` and ``CentralEncoder``,
the ``MLP`` model (``MLPSubstructures``), random features, and the
layer's ``degree_as_tag``.

Inputs are seeded numpy; weights come from the reference's flax tree
through ``params.py``.  Tolerances: forward rtol 2e-4 / atol 2e-5,
gradients rtol 2e-3 / atol 1e-4 * max|g|, BN statistics rtol 1e-4 /
atol 1e-5 (tests/test_mxu_integration.py:48, 79-84).  Random features
are drawn from different generators in the two packages, so they are
tested as dropout is: their shape, range and fresh draws, and parity
with one draw given to both.
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
from gsn_tpu.nn import models as jax_models
from gsn_tpu.nn.embedding import CentralEncoder as JaxCentral
from gsn_tpu.nn.embedding import DiscreteEmbedding as JaxEmbedding
from gsn_tpu.nn.filters import GSNLayer as JaxLayer
from gsn_tpu.nn.models import build_model as jax_build_model
from gsn_tpu.train import metrics as jax_metrics
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import make_molhiv_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.nn.embedding import CentralEncoder, DiscreteEmbedding
from gsn_tpu_torch.nn.filters import GSNLayer
from gsn_tpu_torch.nn.models import (MLPSubstructures, build_model,
                                     edge_segments)
from gsn_tpu_torch.params import flax_to_state_dict, load_flax_variables
from gsn_tpu_torch.train import metrics

from test_torch_gin import counted_imdb, imdb_kwargs

FWD = dict(rtol=2e-4, atol=2e-5)
CAPS = (1024, 4096, 256)
NUM_GRAPHS = 16


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


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def encoder_input(kind, rng, rows=40):
    """(input rows, d_in_features, d_in_encoder) for an encoder kind."""
    if kind in ("linear", "mlp", "None", "zero_encoder"):
        return rng.randn(rows, 5).astype(np.float32), 5, None
    if kind in ("atom_one_hot_encoder",):
        from gsn_tpu_torch.nn.embedding import ATOM_FEATURE_DIMS
        return np.stack([rng.randint(0, v, rows)
                         for v in ATOM_FEATURE_DIMS], 1), 9, None
    if kind in ("bond_one_hot_encoder",):
        from gsn_tpu_torch.nn.embedding import BOND_FEATURE_DIMS
        return np.stack([rng.randint(0, v, rows)
                         for v in BOND_FEATURE_DIMS], 1), 3, None
    vocab = [4, 7]
    return np.stack([rng.randint(0, v, rows) for v in vocab], 1), 2, vocab


@pytest.mark.parametrize("bn_mlp", [False, True])
@pytest.mark.parametrize("kind", ["zero_encoder", "linear", "mlp",
                                  "one_hot_encoder", "embedding",
                                  "atom_one_hot_encoder",
                                  "bond_one_hot_encoder", "None"])
def test_encoder_kinds_match(kind, bn_mlp):
    """Each kind in train mode with a row mask: the output (real rows),
    its width, every parameter gradient and the ``mlp`` kind's masked BN
    statistics."""
    rng = np.random.RandomState(len(kind))
    x, d_in, vocab = encoder_input(kind, rng)
    mask = rng.rand(x.shape[0]) > 0.2
    jenc = JaxEmbedding(kind, d_in, vocab, 6, activation_mlp="relu",
                        bn_mlp=bn_mlp)
    v = jenc.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(mask),
                  False)
    enc = DiscreteEmbedding(kind, d_in, vocab, 6, activation_mlp="relu",
                            bn_mlp=bn_mlp).train()
    load_flax_variables(enc, numpy_tree(v.get("params", {})),
                        numpy_tree(v.get("batch_stats", {})))
    w = rng.randn(x.shape[0], enc.d_out).astype(np.float32) * mask[:, None]

    def loss(params):
        out, mutated = jenc.apply(
            {**v, "params": params}, jnp.asarray(x), jnp.asarray(mask),
            True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mutated)

    (_, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v.get("params", {}))
    out = enc(t(x), t(mask))
    assert out.shape == (x.shape[0], jenc.d_out) == (x.shape[0], enc.d_out)
    np.testing.assert_allclose(out.detach().numpy()[mask],
                               np.asarray(jout)[mask], **FWD)
    if list(enc.parameters()):
        (out * t(w)).sum().backward()
        grads_close({n: p.grad.numpy() for n, p in enc.named_parameters()},
                    flax_to_state_dict(numpy_tree(jgrads)))
    if "batch_stats" in mutated:
        stats_close(enc, mutated)


@pytest.mark.parametrize("kind,extend", [("one_hot_encoder", True),
                                         ("one_hot_encoder", False),
                                         ("embedding", True),
                                         ("embedding", False)])
def test_central_encoder_matches(kind, extend):
    """``(x_central, x_nb)`` and the width, with the learned central row
    carried by the bridge and its gradient."""
    rng = np.random.RandomState(1)
    x_nb = rng.randn(30, 5).astype(np.float32)
    jc = JaxCentral(kind, 5, extend)
    v = jc.init(jax.random.PRNGKey(3), jnp.asarray(x_nb), 11)
    c = CentralEncoder(kind, 5, extend)
    load_flax_variables(c, numpy_tree(v.get("params", {})))
    assert c.d_out == jc.d_out
    w = rng.randn(11, c.d_out).astype(np.float32)

    def loss(params):
        xc, xn = jc.apply({"params": params}, jnp.asarray(x_nb), 11)
        return jnp.sum(xc * w), (xc, xn)

    (_, (jxc, jxn)), jgrads = jax.value_and_grad(loss, has_aux=True)(
        v.get("params", {}))
    xc, xn = c(t(x_nb), 11)
    np.testing.assert_array_equal(xc.detach().numpy(), np.asarray(jxc))
    np.testing.assert_array_equal(xn.numpy(), np.asarray(jxn))
    if kind == "embedding" and extend:
        (xc * t(w)).sum().backward()
        np.testing.assert_allclose(c.central.grad.numpy(),
                                   np.asarray(jgrads["central"]), **FWD)
    else:
        assert not list(c.parameters())


# ---------------------------------------------------------------------------
# MLPSubstructures
# ---------------------------------------------------------------------------

def mlp_kwargs(d_id, scope, **over):
    """tests/test_model_families.py:97's baseline, at both id scopes."""
    kw = dict(model_name="MLP", num_layers=1, d_out=16, out_features=1,
              id_scope=scope, id_embedding="one_hot_encoder",
              input_node_encoder="atom_encoder", readout="sum",
              in_features=9, in_edge_features=3, d_in_id=d_id,
              flow="source_to_target")
    kw.update(over)
    return kw


@pytest.mark.parametrize("scope,readout", [("local", "sum"),
                                           ("local", "mean"),
                                           ("global", "sum")])
def test_mlp_substructures_matches(scope, readout):
    """The MLP baseline: eval prediction, the BCE loss, every parameter
    gradient and the edge MLP's masked BN statistics."""
    graphs, d_id = make_molhiv_like(NUM_GRAPHS, seed=4)
    if scope == "global":
        from gsn_tpu_torch.data.encoding import encode
        from gsn_tpu_torch.data.pipeline import generate_dataset
        from gsn_tpu_torch.graphs.patterns import cycle_graph
        for g in graphs:
            g.pop("identifiers")
        graphs, _ = generate_dataset(graphs, [cycle_graph(k)
                                              for k in (3, 4, 5, 6)],
                                     id_scope="global")
        graphs, _e, d_id, _ed, _dd = encode(graphs, "one_hot_unique")
    kw = mlp_kwargs(d_id, scope, readout=readout)
    jb = next(jax_batches(copy.deepcopy(graphs), NUM_GRAPHS, caps=CAPS,
                          y_shape=(), y_dtype=np.float32))
    tb = next(iterate_batches(graphs, NUM_GRAPHS, caps=CAPS, y_shape=(),
                              y_dtype=np.float32)).to("cpu")
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), jb, train=False)
    model = build_model(GSNConfig(**kw))
    assert isinstance(model, MLPSubstructures)
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    gm = np.asarray(jb.graph_mask)
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(tb).numpy()[gm],
                                   np.asarray(jm.apply(v, jb))[gm], **FWD)

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return jax_metrics.bce_with_logits_loss(out, jb.y, jb.graph_mask), \
            mutated

    (jloss, mutated), jgrads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    model.train()
    tloss = metrics.bce_with_logits_loss(model(tb), tb.y, tb.graph_mask)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **FWD)
    grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                flax_to_state_dict(numpy_tree(jgrads)))
    stats_close(model, mutated)


# ---------------------------------------------------------------------------
# random features
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def imdb():
    graphs, d_id = counted_imdb(8, seed=6)
    return graphs, d_id


def test_random_features_draws(imdb, monkeypatch):
    """d_out[0] uniform [0, 1) columns after the input encoder, drawn
    from the generator passed to forward: the same seed gives the same
    prediction, a later draw another."""
    graphs, d_id = imdb
    cfg = GSNConfig(**imdb_kwargs(d_id, random_features=True))
    model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    assert model.conv_0.update_fn.dense_0.in_features == \
        1 + 8 + model.conv_0.central_id.d_out
    tb = next(iterate_batches(graphs, 8)).to("cpu")
    seen = []
    real = torch.rand

    def spy(*shape, **kw):
        out = real(*shape, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(torch, "rand", spy)
    with torch.no_grad():
        a = model(tb, torch.Generator().manual_seed(9))
        b = model(tb, torch.Generator().manual_seed(9))
        gen = torch.Generator().manual_seed(9)
        c1, c2 = model(tb, gen), model(tb, gen)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c1, rtol=0, atol=0)
    assert not torch.equal(c1, c2)
    assert len(seen) == 4
    for r in seen:
        assert r.shape == (tb.x.shape[0], 8) and r.dtype == torch.float32
        assert float(r.min()) >= 0.0 and float(r.max()) < 1.0
    assert abs(float(torch.cat(seen).mean()) - 0.5) < 0.05


@pytest.mark.parametrize("train", [False, True])
def test_random_features_match_with_the_draw_given(imdb, monkeypatch,
                                                   train):
    """One draw given to both packages (the reference's
    ``jax.random.uniform`` returns it; the port takes it as ``noise``):
    the predictions, and in training every parameter gradient, agree."""
    graphs, d_id = imdb
    kw = imdb_kwargs(d_id, random_features=True)
    jb = next(jax_batches(copy.deepcopy(graphs), 8, caps=CAPS))
    tb = next(iterate_batches(graphs, 8, caps=CAPS)).to("cpu")
    draw = np.random.RandomState(8).rand(jb.x.shape[0], 8).astype(
        np.float32)
    jm = jax_build_model(JaxConfig(**kw))
    rngs = {"params": jax.random.PRNGKey(0),
            "random_features": jax.random.PRNGKey(1)}
    v = jm.init(rngs, jb, train=False)
    model = build_model(GSNConfig(**kw))
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    monkeypatch.setattr(jax_models.jax.random, "uniform",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            draw))
    gm = np.asarray(jb.graph_mask)
    if not train:
        model.eval()
        with torch.no_grad():
            got = model(tb, noise=t(draw)).numpy()
        want = jm.apply(v, jb, rngs={"random_features":
                                     jax.random.PRNGKey(1)})
        np.testing.assert_allclose(got[gm], np.asarray(want)[gm], **FWD)
        return

    def loss(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                       jb, train=True, mutable=["batch_stats"],
                       rngs={"random_features": jax.random.PRNGKey(1),
                             "dropout": jax.random.PRNGKey(2)})[0]
        return jax_metrics.cross_entropy_loss(out, jb.y, jb.graph_mask)

    jgrads = jax.grad(loss)(v["params"])
    model.train()
    metrics.cross_entropy_loss(model(tb, noise=t(draw)), tb.y,
                               tb.graph_mask).backward()
    grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                flax_to_state_dict(numpy_tree(jgrads)))


# ---------------------------------------------------------------------------
# degree_as_tag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("retain", [True, False])
@pytest.mark.parametrize("kind", ["general", "gin"])
def test_degree_as_tag_layer_matches(kind, retain):
    """The layer's ``degree_as_tag``: the encoded degrees concatenated
    after x (``retain_features``) or in its place, on the kernel path;
    real rows, every parameter gradient and the BN statistics."""
    graphs, d_id = counted_imdb(NUM_GRAPHS, seed=9)
    rng = np.random.RandomState(2)
    for g in graphs:
        g["x"] = rng.randn(g["x"].shape[0], 4).astype(np.float32)
    jb = next(jax_batches(copy.deepcopy(graphs), NUM_GRAPHS, caps=CAPS))
    tb = next(iterate_batches(graphs, NUM_GRAPHS, caps=CAPS)).to("cpu")

    def encoded(batch):
        """(one-hot degrees capped at 6, one-hot ids) of a batch, each
        package's batch in its own edge order."""
        deg = np.eye(7, dtype=np.float32)[np.minimum(
            np.asarray(batch.degrees).astype(int), 6)]
        ids = np.concatenate(
            [np.eye(v, dtype=np.float32)[np.asarray(batch.identifiers)[:, i]]
             for i, v in enumerate(d_id)], 1)
        return deg, ids

    kw = dict(msg_kind=kind, id_scope="local", use_ids=True,
              degree_as_tag=True, retain_features=retain,
              flow="source_to_target", activation_mlp="relu", bn_mlp=True)
    deg, enc_ids = encoded(jb)
    jl = JaxLayer(d_up=8, d_msg=8, d_h=(8,), **kw)
    args = (jnp.asarray(jb.x), jb.edge_index, jnp.asarray(enc_ids),
            jnp.asarray(deg), None, jb.node_mask, jb.edge_mask)
    v = jl.init(jax.random.PRNGKey(0), *args, False)
    mask = np.asarray(jb.node_mask)
    w = rng.randn(mask.shape[0], 8).astype(np.float32) * mask[:, None]

    def loss(params):
        out, mutated = jl.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, *args,
            True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mutated)

    (_, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])
    layer = GSNLayer(4, 8, 8, (8,), d_id=sum(d_id), d_degree=7,
                     **kw).train()
    load_flax_variables(layer, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    deg, enc_ids = encoded(tb)
    out = layer(tb.x, tb.edge_index, t(enc_ids), t(deg), None, tb.node_mask,
                tb.edge_mask, edge_segments(tb), tb.in_degree)
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[mask],
                               np.asarray(jout)[mask], **FWD)
    grads_close({n: p.grad.numpy() for n, p in layer.named_parameters()},
                flax_to_state_dict(numpy_tree(jgrads)))
    stats_close(layer, mutated)
