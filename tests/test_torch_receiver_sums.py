"""Receiver-side segment sums through K3 over ``recv_ptr`` against the
reference package, on the CPU.

The mean aggregation of the GSN layer (``general`` kind, and the ``ogb``
kind's per-edge branch, which ``aggr="mean"`` takes) and the DGN
``var``/``std`` aggregators and softmax weights sum per-edge rows at
their receivers.  The port sums them with K3 over the batch's
``recv_ptr`` (its plain version here), one fixed order per receiver,
where it once used a float-atomic ``index_add``; the reference sums them
with ``jax.ops.segment_sum``.  Same inputs through both: the ZINC GSN-EF
model at d=16 and 2 layers, and the DGN model, with weights carried by
the weight bridge.  Tolerances: forward rtol 2e-4 / atol 2e-5, gradients
rtol 2e-3 / atol 1e-4 * max|g| (tests/test_mxu_integration.py:48,79-84).
"""

import copy

import flax
import jax
import numpy as np
import pytest
import torch

from gsn_tpu.config import GSNConfig as JaxConfig
from gsn_tpu.graphs.batching import iterate_batches as jax_batches
from gsn_tpu.nn import dgn as jax_dgn
from gsn_tpu.nn.models import build_model as jax_build_model
from gsn_tpu.train import metrics as jax_metrics
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import make_dgn_like, make_zinc_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.nn import dgn, filters
from gsn_tpu_torch.nn.models import build_model
from gsn_tpu_torch.ops import segment
from gsn_tpu_torch.params import flax_to_state_dict, load_flax_variables
from gsn_tpu_torch.train import metrics

CAPS = (512, 1024, 16)
FWD = dict(rtol=2e-4, atol=2e-5)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def assert_grads_close(got, want):
    scale = max(float(np.max(np.abs(v))) for v in want.values())
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=2e-3,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.fixture
def no_index_add(monkeypatch):
    """Make the masked ``index_add`` sums raise wherever the layers and
    the DGN aggregators could reach them."""
    def boom(*args, **kwargs):
        raise AssertionError("a receiver sum took the index_add path")

    for mod in (filters, dgn):
        monkeypatch.setattr(mod, "masked_segment_sum", boom)
        monkeypatch.setattr(mod, "masked_segment_mean", boom)


def zinc_kwargs(d_id, **over):
    kw = dict(model_name="GSN_edge_sparse", num_layers=2, d_out=16,
              out_features=1, msg_kind="general", id_scope="global",
              bn_mlp=False, id_embedding="one_hot_encoder",
              input_node_encoder="embedding", edge_encoder="embedding",
              readout="sum", in_features=1, d_in_node_encoder=[28],
              d_in_edge_encoder=[4], d_in_id=d_id, aggr="mean")
    kw.update(over)
    return kw


# the ogb message is additive (relu(x_j + id + e)): every encoder emits
# the node width
OGB = dict(msg_kind="ogb", id_embedding="embedding", d_out_id_embedding=16,
           d_out_edge_encoder=16)


@pytest.mark.parametrize("kind", ["general", "ogb"])
def test_mean_aggregation_matches_reference(kind, no_index_add):
    """``aggr="mean"``: the prediction in eval and train mode and every
    parameter gradient of the L1 loss, with the receiver means from K3
    over ``recv_ptr`` divided by the in-degree clamped to 1."""
    graphs, d_id = make_zinc_like(16)
    kw = zinc_kwargs(d_id, **(OGB if kind == "ogb" else {}))
    jb = next(jax_batches(copy.deepcopy(graphs), 16, caps=CAPS,
                          y_dtype=np.float32))
    tb = next(iterate_batches(graphs, 16, caps=CAPS,
                              y_dtype=np.float32)).to("cpu")
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), jb, train=False)
    model = build_model(GSNConfig(**kw))
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))

    model.eval()
    with torch.no_grad():
        got = model(tb).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jb)), **FWD)

    def loss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, jb,
                          train=True, mutable=["batch_stats"])
        return jax_metrics.l1_loss(out, jb.y, jb.graph_mask), out

    (jl, jout), jgrads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    model.train()
    out = model(tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD)
    metrics.l1_loss(out, tb.y, tb.graph_mask).backward()
    assert_grads_close({n: p.grad.numpy()
                        for n, p in model.named_parameters()},
                       flax_to_state_dict(numpy_tree(jgrads)))


def test_receiver_mean_guards_empty_segments():
    """Receivers with no edge get 0, the padding rows after the real
    edges are ignored, and the sum's gradient is 0 on them."""
    rows = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    rows.requires_grad_(True)
    ptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    got = segment.receiver_mean(rows, ptr)
    want = torch.tensor([[1.0, 2.0], [0.0, 0.0], [6.0, 7.0]])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.sum().backward()
    assert rows.grad[5].abs().sum() == 0
    torch.testing.assert_close(rows.grad[:5, 0],
                               torch.tensor([.5, .5, 1 / 3, 1 / 3, 1 / 3]))


DGN_AGGS = ("mean", "var", "std", "dir0-0.1", "dir1-neg-0.5", "max")


def test_dgn_var_std_softmax_match_reference(no_index_add):
    """The DGN model whose aggregators include ``var``, ``std`` and two
    softmax weights: eval and train predictions, every gradient and the
    running BN statistics after one training forward, against
    ``gsn_tpu``'s DGNNet on its plain layout."""
    graphs = make_dgn_like(24, seed=1)
    avg_d = dgn.compute_avg_d(graphs)
    kw = dict(hidden_dim=16, out_dim=16, num_layers=2, aggregators=DGN_AGGS,
              avg_d=avg_d, dropout=0.0)
    jb = next(jax_batches(copy.deepcopy(graphs), 24, caps=(1024, 2048, 32),
                          y_shape=(), y_dtype=np.float32))
    tb = next(iterate_batches(graphs, 24, caps=(1024, 2048, 32),
                              y_shape=(), y_dtype=np.float32)).to("cpu")
    jm = jax_dgn.DGNNet(jax_dgn.DGNConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), jb, train=False)
    model = dgn.DGNNet(dgn.DGNConfig(**kw))
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(tb).numpy(),
                                   np.asarray(jm.apply(v, jb)), **FWD)

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return ((out ** 2) * jb.graph_mask[:, None]).sum(), mutated

    (_, mutated), jgrads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    model.train()
    out = model(tb)
    ((out ** 2) * tb.graph_mask[:, None]).sum().backward()
    assert_grads_close({n: p.grad.numpy()
                        for n, p in model.named_parameters()},
                       flax_to_state_dict(numpy_tree(jgrads)))
    state = model.state_dict()
    for name, ref in flax_to_state_dict(
            {}, numpy_tree(mutated["batch_stats"])).items():
        np.testing.assert_allclose(state[name].numpy(), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", ["mean", "var", "std", "dir0-0.1"])
def test_dgn_aggregate_receiver_sums_match_masked(name):
    """``dgn_aggregate`` with ``recv_ptr`` (K3 sums) equals the masked
    ``index_add`` version on the same receiver-sorted edges."""
    rng = np.random.RandomState(4)
    n, e, d = 9, 40, 5
    dst = np.sort(rng.randint(0, n - 1, e))
    src = rng.randint(0, n, e)
    h_in = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    vf = torch.from_numpy(rng.randn(e, 2).astype(np.float32))
    ptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(dst, minlength=n), out=ptr[1:])
    dst_t = torch.from_numpy(dst)
    want = dgn.dgn_aggregate(name, h_in[src], vf, h_in, dst_t, n)
    got = dgn.dgn_aggregate(name, h_in[src], vf, h_in, dst_t, n,
                            recv_ptr=torch.from_numpy(ptr))
    torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-6)
