"""The port's epoch loop (``Trainer.fit``), ReduceLROnPlateau,
checkpoints and the ZINC model's head against the reference package on
the CPU.

The model is the published ZINC GSN-EF configuration
(``scripts/zinc_10_runs.py``: one-hot encoders for atoms, bonds and
cycle-count ids, ``general`` messages with BN in the message MLP, the
``jk_mlp`` head with ``final_projection=False``, sum readout, L1) cut to
d=16 and 2 layers, on 40 ZINC-like graphs split 24/8/8.  Weights are
carried from the reference's ``init`` through the weight bridge.
Tolerances: forward rtol 2e-4 / atol 2e-5, gradients rtol 2e-3 / atol
1e-4 * max|g| (tests/test_mxu_integration.py:48,79-84), histories rtol
1e-3 (tests/test_torch_model.py::test_trainer_loss_trajectory_matches);
the lr at each evaluation exactly.
"""

import copy

import flax
import jax
import numpy as np
import pytest
import torch

from gsn_tpu.config import GSNConfig as JaxConfig
from gsn_tpu.graphs.batching import iterate_batches as jax_batches
from gsn_tpu.nn.models import build_model as jax_build_model
from gsn_tpu.train import loop as jax_loop
from gsn_tpu.train import metrics as jax_metrics
from gsn_tpu.train import optim as jax_optim
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import make_zinc_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.nn.filters import GSNLayer
from gsn_tpu_torch.nn.models import build_model, edge_segments
from gsn_tpu_torch.params import flax_to_state_dict, load_flax_variables
from gsn_tpu_torch.train import loop, metrics, optim
from gsn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

FWD = dict(rtol=2e-4, atol=2e-5)
HIST_RTOL = 1e-3
HIST_KEYS = ("train_losses", "train_accs", "test_losses", "test_accs",
             "val_losses", "val_accs")


def zinc_cli_kwargs(d_id, **over):
    """scripts/zinc_10_runs.py's model at d=16, 2 layers (the CLI's
    bn_mlp default, True, included)."""
    kw = dict(model_name="GSN_edge_sparse", num_layers=2, d_out=16,
              out_features=1, msg_kind="general", id_scope="global",
              bn_mlp=True, id_embedding="one_hot_encoder",
              input_node_encoder="one_hot_encoder",
              edge_encoder="one_hot_encoder", final_projection=[False],
              jk_mlp=True, readout="sum", dropout_features=0.0,
              in_features=1, d_in_node_encoder=[28], d_in_edge_encoder=[4],
              d_in_id=d_id)
    kw.update(over)
    return kw


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


@pytest.fixture(scope="module")
def zinc():
    graphs, d_id = make_zinc_like(40, seed=3)
    return dict(graphs=graphs, d_id=d_id, train=graphs[:24],
                test=graphs[24:32], val=graphs[32:])


class Recorder:
    """A ``logger`` for ``fit``: keeps each evaluation's record."""

    def __init__(self):
        self.records = []

    def log(self, rec, step=None):
        self.records.append(dict(rec, step=step))


def tcfg_kwargs(**over):
    kw = dict(lr=1e-3, batch_size=8, scheduler="ReduceLROnPlateau",
              decay_rate=0.5, patience=1, min_lr=1e-5, num_epochs=4,
              eval_frequency=1, loss_fn="L1Loss", prediction_fn="L1Loss",
              seed=5, shuffle=True,
              # the reference's per-step path (its scanned epochs give the
              # same numbers, and cannot carry a model with no BN state)
              scan_epochs=False)
    kw.update(over)
    return kw


def fit_both(zinc, tkw):
    """``fit`` of both packages from the same carried weights; returns
    ((hist, records) of the reference, (hist, records) of the port).

    The model has no BN: a bias ahead of a BN has a gradient of pure
    rounding noise, which Adam turns into lr-sized steps of arbitrary
    sign, and the eval-mode output then sees them through the running
    mean (tests/test_torch_model.py::test_trainer_loss_trajectory_matches
    evaluates before training for that reason).  The head tests below
    hold the BN model itself."""
    kw = zinc_cli_kwargs(zinc["d_id"], bn=False, bn_mlp=False)
    splits = (zinc["train"], zinc["test"])
    jt = jax_loop.Trainer(JaxConfig(**kw), jax_loop.TrainerConfig(**tkw),
                          zinc["train"])
    example = next(jax_batches(zinc["train"], tkw["batch_size"]))
    jstate = jt.init_state(example, seed=0)
    jrec = Recorder()
    _, jhist = jt.fit(jstate, *splits, graphs_val=zinc["val"], log_fn=None,
                      logger=jrec)

    tt = loop.Trainer(GSNConfig(**kw), loop.TrainerConfig(**tkw),
                      copy.deepcopy(zinc["train"]), device="cpu")
    tstate = tt.init_state(seed=0)
    init = jt.init_state(example, seed=0)
    load_flax_variables(tstate.model, numpy_tree(init.params),
                        numpy_tree(init.batch_stats))
    trec = Recorder()
    _, thist = tt.fit(tstate, *copy.deepcopy(splits),
                      graphs_val=copy.deepcopy(zinc["val"]), log_fn=None,
                      logger=trec)
    return (jhist, jrec.records), (thist, trec.records)


def assert_fits_match(ref, got):
    (jhist, jrecs), (thist, trecs) = ref, got
    for key in HIST_KEYS:
        assert len(thist[key]) == len(jhist[key]) > 0, key
        np.testing.assert_allclose(thist[key], jhist[key], rtol=HIST_RTOL,
                                   err_msg=key)
    assert [r["lr"] for r in trecs] == [r["lr"] for r in jrecs]
    assert [r["step"] for r in trecs] == [r["step"] for r in jrecs]


def test_fit_plateau_matches_reference(zinc):
    """Shuffled epochs from one seed, Plateau (patience 1) on the val
    loss: every history list and the lr at each evaluation."""
    ref, got = fit_both(zinc, tcfg_kwargs())
    assert_fits_match(ref, got)
    lrs = [r["lr"] for r in got[1]]
    assert min(lrs) < lrs[0], f"the plateau never decayed the lr: {lrs}"


def test_fit_steplr_wraparound_matches_reference(zinc):
    """StepLR every epoch and num_iters (5) above the 3 batches of an
    epoch, so each epoch wraps around to its first batches."""
    ref, got = fit_both(zinc, tcfg_kwargs(scheduler="StepLR", decay_steps=1,
                                          num_iters=5, num_epochs=3))
    assert_fits_match(ref, got)
    assert [r["lr"] for r in got[1]] == [1e-3 * 0.5 ** e for e in (1, 2, 3)]


def test_fit_min_lr_stops_like_reference(zinc):
    """The loop ends once the lr falls below min_lr (StepLR halving
    every epoch, min_lr between the rates after epochs 2 and 3), after
    the evaluations of epochs 0 and 2."""
    ref, got = fit_both(zinc, tcfg_kwargs(scheduler="StepLR", decay_steps=1,
                                          min_lr=1e-4, num_epochs=6,
                                          eval_frequency=2))
    assert_fits_match(ref, got)
    assert [r["step"] for r in got[1]] == [0, 2]


@pytest.mark.parametrize("mode", ["min", "max"])
def test_reduce_lr_on_plateau_matches_reference(mode):
    metrics_seq = [3.0, 2.5, 2.6, 2.7, 2.4, 2.4, 2.45, 2.5, 2.6, 1.0, 1.1,
                   1.2, 1.3, 1.4]
    ours = optim.make_scheduler("ReduceLROnPlateau", 0.01, decay_rate=0.3,
                                patience=2, mode=mode)
    ref = jax_optim.make_scheduler("ReduceLROnPlateau", 0.01,
                                   decay_rate=0.3, patience=2, mode=mode)
    got, want = [], []
    for m in metrics_seq:
        got.append(ours.step(m))
        want.append(ref.step(m))
        assert ours.state_dict() == ref.state_dict()
    assert got == want
    assert len(set(got)) > 1
    again = optim.make_scheduler("ReduceLROnPlateau", 0.01, patience=2)
    again.load_state_dict(ours.state_dict())
    assert again.state_dict() == ours.state_dict()


def _fresh_trainer(zinc, tkw):
    kw = zinc_cli_kwargs(zinc["d_id"], dropout_features=0.3)
    return loop.Trainer(GSNConfig(**kw), loop.TrainerConfig(**tkw),
                        zinc["train"], device="cpu")


def test_checkpoint_resume_is_bit_identical(zinc, tmp_path):
    """2 epochs, a checkpoint, a new trainer resumed from it for 2 more:
    the same weights, BN statistics, optimizer state and histories, bit
    for bit, as 4 epochs straight (shuffle, dropout and Plateau on)."""
    tkw = tcfg_kwargs(num_epochs=4)
    splits = (zinc["train"], zinc["test"])
    straight = _fresh_trainer(zinc, tkw)
    s_state, s_hist = straight.fit(straight.init_state(seed=1), *splits,
                                   graphs_val=zinc["val"], log_fn=None)

    ckpt = str(tmp_path / "ckpt" / "checkpoint.pt")
    first = _fresh_trainer(zinc, tcfg_kwargs(num_epochs=2))
    f_state, _ = first.fit(first.init_state(seed=1), *splits,
                           graphs_val=zinc["val"], checkpoint_file=ckpt,
                           log_fn=None)
    second = _fresh_trainer(zinc, tkw)
    state, start = load_checkpoint(ckpt, second.init_state(seed=7),
                                   second.scheduler, second.rng)
    assert start == 2 and state.epoch == 2
    r_state, r_hist = second.fit(state, *splits, graphs_val=zinc["val"],
                                 log_fn=None)
    for key in HIST_KEYS:
        assert r_hist[key] == s_hist[key][2:], key
    want, got = s_state.model.state_dict(), r_state.model.state_dict()
    assert set(want) == set(got)
    for name in want:
        assert torch.equal(want[name], got[name]), name
    for a, b in zip(s_state.optimizer.state.values(),
                    r_state.optimizer.state.values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert second.scheduler.state_dict() == straight.scheduler.state_dict()
    assert torch.equal(r_state.dropout_gen.get_state(),
                       s_state.dropout_gen.get_state())


def test_checkpoint_file_is_replaced_whole(zinc, tmp_path):
    """save_checkpoint writes through a .tmp file it then moves."""
    t = _fresh_trainer(zinc, tcfg_kwargs())
    state = t.init_state(seed=0)
    state.epoch = 3
    path = str(tmp_path / "c.pt")
    save_checkpoint(path, state, t.scheduler, t.rng)
    save_checkpoint(path, state, t.scheduler, t.rng)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.pt"]
    _, start = load_checkpoint(path, t.init_state(seed=1))
    assert start == 3


@pytest.mark.parametrize("jk_mlp", [True, False])
@pytest.mark.parametrize("final_projection", [[False], [True]])
def test_head_forward_and_gradients_match(zinc, jk_mlp, final_projection):
    """GNNSubstructures with the jk_mlp head (an MLP with BN over the
    graph slots) or a Dense head, on the last layer only
    (final_projection=False) or on every layer: train-mode prediction,
    running BN statistics and every parameter gradient of the L1 loss,
    and the eval-mode prediction."""
    kw = zinc_cli_kwargs(zinc["d_id"], jk_mlp=jk_mlp,
                         final_projection=final_projection)
    graphs = zinc["graphs"][:20]
    caps = (1024, 2048, 32)
    jb = next(jax_batches(copy.deepcopy(graphs), 20, caps=caps,
                          y_dtype=np.float32))
    tb = next(iterate_batches(graphs, 20, caps=caps,
                              y_dtype=np.float32)).to("cpu")
    jm = jax_build_model(JaxConfig(**kw))
    v = jm.init(jax.random.PRNGKey(2), jb, train=False)

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return jax_metrics.l1_loss(out, jb.y, jb.graph_mask), (out, mutated)

    (jl, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])
    model = build_model(GSNConfig(**kw))
    load_flax_variables(model, numpy_tree(v["params"]),
                        numpy_tree(v["batch_stats"]))
    model.train()
    out = model(tb)
    tl = metrics.l1_loss(out, tb.y, tb.graph_mask)
    tl.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(tl.item(), float(jl), **FWD)
    want = flax_to_state_dict(numpy_tree(jgrads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(np.max(np.abs(w))) for w in want.values())
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=2e-3,
                                   atol=1e-4 * scale, err_msg=name)
    state = model.state_dict()
    for name, ref in flax_to_state_dict(
            {}, numpy_tree(mutated["batch_stats"])).items():
        np.testing.assert_allclose(state[name].numpy(), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    model.eval()
    with torch.no_grad():
        got_eval = model(tb)
    want_eval = jm.apply({"params": v["params"],
                          "batch_stats": mutated["batch_stats"]}, jb,
                         train=False)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               **FWD)


def test_per_edge_aggregate_is_the_sorted_segment_sum(zinc):
    """An f32 ``general`` layer with BN in its message MLP (the published
    ZINC flags' route) sums its per-edge messages over the batch's
    receiver-sorted segments: the same output and gradients as the
    masked segment sum it takes without a segment layout."""
    graphs = zinc["graphs"][:12]
    data = next(iterate_batches(graphs, 12, y_dtype=np.float32,
                                caps=(512, 1024, 16))).to("cpu")
    torch.manual_seed(0)
    layer = GSNLayer(16, 16, 16, (16,), msg_kind="general",
                     id_scope="global", use_ids=False, bn_mlp=True,
                     activation_mlp="relu", flow="source_to_target").train()
    x = torch.randn(data.num_node_slots, 16)
    outs, grads = [], []
    for seg in (edge_segments(data), None):
        xl = x.clone().requires_grad_(True)
        out = layer(xl, data.edge_index, node_mask=data.node_mask,
                    edge_mask=data.edge_mask, seg=seg,
                    in_degree=data.in_degree)
        (out[data.node_mask] ** 2).sum().backward()
        outs.append(out.detach())
        grads.append(xl.grad)
    assert not layer.msg_fn.fusable
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **FWD)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=2e-3, atol=1e-4 * float(
                                   grads[1].abs().max()))
