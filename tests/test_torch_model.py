"""The port's model, BN, losses, optimizer and trainer against the
reference package on the CPU.

The model is the ZINC GSN-EF configuration (``bench.py::zinc_cfg``) cut
to d=16 and 2 layers, on 20 ZINC-like graphs batched at caps
(1024, 2048, 256): node_cap >= 512 and graph_cap >= 256, so the reference
runs its slab message and slab pool kernels (interpret mode) rather than
the plain XLA ops.  Weights come from the reference's ``init`` through
the weight bridge.  Tolerances: forward rtol 2e-4 / atol 2e-5, gradients
rtol 2e-3 / atol 1e-4 * max|g| (tests/test_mxu_integration.py:48,79-84),
loss trajectories rtol 1e-3.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gsn_tpu.config import GSNConfig as JaxConfig
from gsn_tpu.graphs.batching import iterate_batches as jax_batches
from gsn_tpu.nn.models import build_model as jax_build_model
from gsn_tpu.ops.norm import MaskedBatchNorm as JaxBN
from gsn_tpu.train import loop as jax_loop
from gsn_tpu.train import metrics as jax_metrics
from gsn_tpu.train.optim import make_optimizer as jax_make_optimizer
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import make_zinc_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.nn.models import build_model
from gsn_tpu_torch.ops.norm import MaskedBatchNorm
from gsn_tpu_torch.params import flax_to_state_dict, load_flax_variables
from gsn_tpu_torch.train import loop
from gsn_tpu_torch.train import metrics
from gsn_tpu_torch.train.optim import make_optimizer

SLAB = {"mode": "slab", "flow": "source_to_target",
        "block_n": 128, "block_e": 256}
CAPS = (1024, 2048, 256)
NUM_GRAPHS = 20
FWD = dict(rtol=2e-4, atol=2e-5)


def zinc_kwargs(d_id):
    """bench.py::zinc_cfg at d=16, 2 layers."""
    return dict(model_name="GSN_edge_sparse", num_layers=2, d_out=16,
                out_features=1, msg_kind="general", id_scope="global",
                bn_mlp=False, id_embedding="one_hot_encoder",
                input_node_encoder="embedding", edge_encoder="embedding",
                readout="sum", in_features=1, d_in_node_encoder=[28],
                d_in_edge_encoder=[4], d_in_id=d_id)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def assert_grads_close(got, want):
    scale = max(float(np.max(np.abs(v))) for v in want.values())
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=2e-3,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.fixture(scope="module")
def zinc():
    graphs, d_id = make_zinc_like(NUM_GRAPHS)
    kw = zinc_kwargs(d_id)
    jb = next(jax_batches(copy.deepcopy(graphs), NUM_GRAPHS, caps=CAPS,
                          y_dtype=np.float32, mxu_layout=SLAB))
    assert jb.seg_mode == "slab" and jb.pool_recv_local is not None
    tb = next(iterate_batches(graphs, NUM_GRAPHS, caps=CAPS,
                              y_dtype=np.float32)).to("cpu")
    jmodel = jax_build_model(JaxConfig(**kw))
    variables = jmodel.init(jax.random.PRNGKey(0), jb, train=False)
    return dict(graphs=graphs, kw=kw, jb=jb, tb=tb, jmodel=jmodel,
                variables=variables)


def bridged_model(zinc):
    model = build_model(GSNConfig(**zinc["kw"]))
    load_flax_variables(model, numpy_tree(zinc["variables"]["params"]),
                        numpy_tree(zinc["variables"]["batch_stats"]))
    return model


@pytest.mark.parametrize("train", [False, True])
def test_prediction_matches(zinc, train):
    jm, v, jb = zinc["jmodel"], zinc["variables"], zinc["jb"]
    if train:
        want, _ = jm.apply(v, jb, train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jb, train=False)
    model = bridged_model(zinc).train(train)
    with torch.no_grad():
        got = model(zinc["tb"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_gradients_and_batch_stats_match(zinc):
    """Every parameter gradient of the L1 loss, and the running BN
    statistics after one training forward."""
    jm, v, jb = zinc["jmodel"], zinc["variables"], zinc["jb"]

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return jax_metrics.l1_loss(out, jb.y, jb.graph_mask), mutated

    (jl, mutated), jgrads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    model = bridged_model(zinc).train()
    tb = zinc["tb"]
    tl = metrics.l1_loss(model(tb), tb.y, tb.graph_mask)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **FWD)
    assert_grads_close(
        {n: p.grad.numpy() for n, p in model.named_parameters()},
        flax_to_state_dict(numpy_tree(jgrads)))
    state = model.state_dict()
    for name, ref in flax_to_state_dict(
            {}, numpy_tree(mutated["batch_stats"])).items():
        np.testing.assert_allclose(state[name].numpy(), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_trainer_loss_trajectory_matches(zinc):
    """``evaluate`` on the whole set, then three Trainer.train_steps on
    one batch in both packages from the same carried weights.  (Evaluate
    runs before training: Adam turns the pure-noise gradients of biases
    ahead of a BatchNorm into lr-sized steps of arbitrary sign, which the
    eval-mode output then sees.)"""
    graphs = zinc["graphs"]
    jt = jax_loop.Trainer(
        JaxConfig(**zinc["kw"]),
        jax_loop.TrainerConfig(lr=1e-3, batch_size=NUM_GRAPHS,
                               scheduler="None", loss_fn="L1Loss",
                               prediction_fn="L1Loss", shuffle=False),
        graphs)
    jstate = jt.init_state(zinc["jb"], seed=0)
    jeval = jt.evaluate(jstate, graphs)
    key = jax.random.PRNGKey(0)
    jlosses = []
    for _ in range(3):
        jstate, jl = jt._jit_train_step(jstate, zinc["jb"], 1e-3, key)
        jlosses.append(float(jl))

    tt = loop.Trainer(
        GSNConfig(**zinc["kw"]),
        loop.TrainerConfig(lr=1e-3, batch_size=NUM_GRAPHS, scheduler="None",
                           loss_fn="L1Loss", prediction_fn="L1Loss"),
        graphs, device="cpu")
    tstate = tt.init_state(seed=0)
    init = jt.init_state(zinc["jb"], seed=0)
    load_flax_variables(tstate.model, numpy_tree(init.params),
                        numpy_tree(init.batch_stats))
    np.testing.assert_allclose(tt.evaluate(tstate, graphs), jeval,
                               rtol=1e-3)
    tlosses = []
    for _ in range(3):
        tstate, tl = tt.train_step(tstate, zinc["tb"])
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)


def test_trainer_without_device_raises_when_no_cuda(zinc, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = loop.TrainerConfig(batch_size=NUM_GRAPHS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.Trainer(GSNConfig(**zinc["kw"]), tcfg, zinc["graphs"])


def test_bridge_rejects_missing_and_unmapped_keys(zinc):
    params = numpy_tree(zinc["variables"]["params"])
    stats = numpy_tree(zinc["variables"]["batch_stats"])
    model = build_model(GSNConfig(**zinc["kw"]))
    extra = copy.deepcopy(params)
    extra["conv_0"]["msg_fn"]["dense_9_bias"] = np.zeros(16, np.float32)
    with pytest.raises(KeyError, match="dense_9_bias"):
        load_flax_variables(model, extra, stats)
    missing = copy.deepcopy(params)
    del missing["lin_proj_0"]
    with pytest.raises(KeyError, match="lin_proj_0"):
        load_flax_variables(model, missing, stats)
    with pytest.raises(KeyError, match="bn_0.running_mean"):
        load_flax_variables(model, params, None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_moments", [False, True])
def test_masked_batchnorm_matches(masked, use_moments):
    """Train-mode output (or folded statistics from ``moments``), the
    running-stat update, and eval-mode output."""
    rng = np.random.RandomState(3)
    x = (rng.randn(40, 6) * 3 + 1).astype(np.float32)
    mask = rng.rand(40) > 0.3 if masked else None
    m = np.ones(40, bool) if mask is None else mask
    moments = (float(m.sum()), (x * m[:, None]).sum(0),
               (x * x * m[:, None]).sum(0))

    jbn = JaxBN()
    jvars = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     use_running_average=True)
    jx = None if use_moments else jnp.asarray(x)
    jm = None if mask is None else jnp.asarray(mask)
    jout, jmut = jbn.apply(
        jvars, jx, jm, use_running_average=False,
        moments=(tuple(map(jnp.asarray, moments)) if use_moments
                 else None), mutable=["batch_stats"])

    bn = MaskedBatchNorm(6).train()
    tx = None if use_moments else torch.from_numpy(x)
    tm = None if mask is None else torch.from_numpy(mask)
    tout = bn(tx, tm, moments=(tuple(map(torch.as_tensor, moments))
                               if use_moments else None))
    if use_moments:
        for a, b in zip(tout, jout):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(tout.detach().numpy(),
                                   np.asarray(jout), rtol=1e-5, atol=1e-5)
    stats = flax_to_state_dict({}, numpy_tree(jmut["batch_stats"]))
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               stats["running_mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               stats["running_var"], rtol=1e-5, atol=1e-6)
    bn.eval()
    jeval = jbn.apply({"params": jvars["params"],
                       "batch_stats": jmut["batch_stats"]},
                      jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jeval), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["L1Loss", "MSELoss", "BCEWithLogitsLoss",
                                  "CrossEntropyLoss"])
def test_losses_and_prediction_fns_match(name):
    rng = np.random.RandomState(5)
    mask = rng.rand(12) > 0.25
    if name == "CrossEntropyLoss":
        pred = rng.randn(12, 4).astype(np.float32)
        y = rng.randint(0, 4, 12)
    else:
        pred = rng.randn(12, 1).astype(np.float32)
        y = (rng.rand(12) > 0.5).astype(np.float32)
    fns = [(metrics.LOSSES[name], jax_metrics.LOSSES[name])]
    pred_name = {"CrossEntropyLoss": "multi_class_accuracy"}.get(name, name)
    if pred_name in metrics.PREDICTION_FNS:
        fns.append((metrics.PREDICTION_FNS[pred_name],
                    jax_metrics.PREDICTION_FNS[pred_name]))
    for tfn, jfn in fns:
        want = float(jfn(jnp.asarray(pred), jnp.asarray(y),
                         jnp.asarray(mask)))
        got = float(tfn(torch.from_numpy(pred), torch.from_numpy(y),
                        torch.from_numpy(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_matches_optax_over_steps(weight_decay):
    """L2-regularized Adam with bias correction: five updates from one
    gradient sequence."""
    rng = np.random.RandomState(6)
    p0 = rng.randn(7).astype(np.float32)
    grads = rng.randn(5, 7).astype(np.float32)
    lr = 3e-2
    tx = jax_make_optimizer(lr, weight_decay)
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([tp], lr, weight_decay)
    for g in grads:
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-5, atol=1e-6)
