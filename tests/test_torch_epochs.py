"""The port's one-dispatch epochs (``TrainerConfig.scan_epochs``) on the
CPU: the run partition against ``gsn_tpu``'s, static shapes per
signature, scanned equal to looped bit for bit, the scanned epochs
against ``gsn_tpu``'s, the graph cache's keys, the launch bookkeeping of
replays, and ``ParallelTrainer`` keeping ``scan_epochs`` on its ranks,
spawned or launched separately.

On the CPU the runs drive the eager step over the executor's static
buffers (no CUDA graph): everything but the capture runs here; the
capture itself is tested on the card (``tests/test_torch_cuda.py``).
Tolerances against the reference: outputs and losses rtol 2e-4 / atol
2e-5, parameters rtol 2e-3 (tests/test_mxu_integration.py:48,79-84),
the biases directly ahead of a BN with an absolute slack of two lr a
step (their gradient is rounding noise, which Adam turns into steps of
up to lr of arbitrary sign in each package, tests/test_torch_model.py::
test_trainer_loss_trajectory_matches).
"""

import copy
import dataclasses
import gc
import os

import flax
import jax
import numpy as np
import pytest
import torch

from gsn_tpu.config import GSNConfig as JaxConfig
from gsn_tpu.graphs.batching import iterate_batches as jax_batches
from gsn_tpu.train import loop as jax_loop
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import (make_dgn_like, make_molhiv_like,
                                          make_zinc_like)
from gsn_tpu_torch.graphs.container import batch_graphs
from gsn_tpu_torch.nn.dgn import DGNConfig, DGNNet, build_agg_ctx, \
    compute_avg_d
from gsn_tpu_torch.nn.models import build_model, edge_segments
from gsn_tpu_torch.ops.cuda import build
from gsn_tpu_torch.ops.cuda.slab_combine import segment_sum_sorted_plain
from gsn_tpu_torch.params import flax_to_state_dict, load_flax_variables
from gsn_tpu_torch.parallel.mesh import Mesh
from gsn_tpu_torch.parallel.trainer import ParallelTrainer
from gsn_tpu_torch.train import loop
from gsn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from gsn_tpu_torch.train.graphs import batch_sig, runs

FWD = dict(rtol=2e-4, atol=2e-5)
PARAM_RTOL = 2e-3


def zinc_kwargs(d_id, **over):
    """``bench.py::zinc_cfg`` (ZINC GSN-EF) at d=16, 2 layers."""
    kw = dict(model_name="GSN_edge_sparse", num_layers=2, d_out=16,
              out_features=1, msg_kind="general", id_scope="global",
              bn_mlp=False, id_embedding="one_hot_encoder",
              input_node_encoder="embedding", edge_encoder="embedding",
              readout="sum", in_features=1, d_in_node_encoder=[28],
              d_in_edge_encoder=[4], d_in_id=d_id)
    kw.update(over)
    return kw


def molhiv_kwargs(d_id):
    """``bench.py::molhiv_cfg`` (GSN-VN-AF) at d=16, 2 layers, dropout
    on."""
    return dict(model_name="GSN_edge_sparse_ogb", num_layers=2, d_out=16,
                d_h=32, out_features=1, msg_kind="ogb", id_scope="local",
                vn=True, dropout_features=0.5, readout="mean",
                final_projection=[False], jk_mlp=False,
                id_embedding="embedding", d_out_id_embedding=16,
                input_node_encoder="atom_encoder",
                edge_encoder="bond_encoder", input_vn_encoder="embedding",
                in_features=9, in_edge_features=3, d_in_id=d_id)


@pytest.fixture(scope="module")
def zinc():
    graphs, d_id = make_zinc_like(40, seed=3)
    return graphs, d_id


def zinc_tcfg(**over):
    kw = dict(lr=1e-3, batch_size=8, scheduler="None", loss_fn="L1Loss",
              prediction_fn="L1Loss", seed=5)
    kw.update(over)
    return loop.TrainerConfig(**kw)


# ---------------------------------------------------------------------------
# runs and signatures
# ---------------------------------------------------------------------------

def assert_same_stream(got, want):
    """Two ``np.random.RandomState``s at the same point of one stream."""
    a, b = got.get_state(), want.get_state()
    assert a[0] == b[0] and a[2:] == b[2:]
    np.testing.assert_array_equal(a[1], b[1])


def drawn_stream(tcfg, num_graphs, epochs):
    """The host stream of ``tcfg.seed`` after ``epochs`` epochs of the
    reference's draws: each epoch's shuffle of its graphs, then one
    number per iteration."""
    rng = np.random.RandomState(tcfg.seed)
    for _ in range(epochs):
        rng.shuffle(np.arange(num_graphs))
        n_iters = tcfg.num_iters or -(-num_graphs // tcfg.batch_size)
        for _ in range(n_iters):
            rng.randint(0, 2**31 - 1)
    return rng


def epoch_seq(batches, num_iters, rng):
    """``train_epoch``'s sequence of batch objects (wrap-around included)
    and its dropout-key draws."""
    n = num_iters or len(batches)
    seq = [batches[k % len(batches)] for k in range(n)]
    for _ in range(n):
        rng.randint(0, 2**31 - 1)
    return seq


@pytest.mark.parametrize("caps_mode", ["worst", "tight"])
@pytest.mark.parametrize("num_iters", [3, None, 8])
def test_runs_match_reference(zinc, caps_mode, num_iters):
    """Two epochs' [i, j) runs of equal signature, the port's against
    ``gsn_tpu``'s ``Trainer._runs(_batch_sig(...))`` on the same graphs
    and seed (num_iters 3 stops short of the 5 batches, 8 wraps around
    them), and the host streams' states after them; then a sequence of
    batches at two caps, alternating in blocks, in both packages."""
    graphs, d_id = zinc
    tcfg = zinc_tcfg(caps_mode=caps_mode, num_iters=num_iters)
    tt = loop.Trainer(GSNConfig(**zinc_kwargs(d_id)), tcfg, graphs,
                      device="cpu")
    jt = jax_loop.Trainer(
        JaxConfig(**zinc_kwargs(d_id)),
        jax_loop.TrainerConfig(**dataclasses.asdict(tcfg)), graphs)
    for _ in range(2):
        tseq = epoch_seq(tt._train_batches(graphs), num_iters, tt.rng)
        jseq = epoch_seq(jt._train_batches(graphs), num_iters, jt.rng)
        got = list(runs([batch_sig(b) for b in tseq]))
        want = list(jt._runs([jt._batch_sig(b) for b in jseq]))
        assert got == want
        assert [b.num_real_edges for b in tseq] == [
            int(b.edge_mask.sum()) for b in jseq]
        assert_same_stream(tt.rng, jt.rng)
    caps = [(640, 1536, 8), (768, 2048, 8)]
    pick = [0, 0, 1, 1, 1, 0, 1]
    chunks = [graphs[8 * (k % 5):8 * (k % 5) + 8] for k in range(len(pick))]
    tseq = [batch_graphs(c, *caps[p]) for c, p in zip(chunks, pick)]
    jseq = [next(jax_batches(c, 8, caps=caps[p])) for c, p in zip(chunks,
                                                                   pick)]
    got = list(runs([batch_sig(b) for b in tseq]))
    assert got == list(jt._runs([jt._batch_sig(b) for b in jseq]))
    assert got == [(0, 2), (2, 5), (5, 6), (6, 7)]


def module_shapes(model, data, **kw):
    """(module name, output shapes and dtypes) of every submodule's
    forward, in call order, and the gradients' shapes."""
    seen = []

    def hook(name):
        def fn(_m, _inp, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            seen.append((name, tuple((tuple(o.shape), o.dtype)
                                     for o in outs
                                     if isinstance(o, torch.Tensor))))
        return fn

    handles = [m.register_forward_hook(hook(n))
               for n, m in model.named_modules() if n]
    try:
        out = model(data, **kw)
        out.float().sum().backward()
    finally:
        for h in handles:
            h.remove()
    grads = [(n, tuple(p.grad.shape)) for n, p in model.named_parameters()
             if p.grad is not None]
    model.zero_grad(set_to_none=True)
    return seen, grads


def fields(x):
    return [(tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else t
            for t in x]


def test_shapes_static_per_signature(zinc):
    """Two batches at the same caps with different real edge counts: the
    same signature, and the same shapes and dtypes of everything
    ``edge_segments``, the GSN layers (the kernel path, f32 and bf16 +
    ``bn_mlp``), GNN_OGB and ``build_agg_ctx`` build.  The padded
    ``send_perm``'s real prefix is the stable sender argsort, and K3's
    plain version over it gives the unpadded permutation's dB bits."""
    graphs, d_id = zinc
    caps = (640, 1536, 16)
    a = batch_graphs(graphs[:16], *caps, y_dtype=np.float32)
    b = batch_graphs(graphs[16:24], *caps, y_dtype=np.float32)
    assert a.num_real_edges != b.num_real_edges
    assert batch_sig(a) == batch_sig(b)
    ta, tb = a.to("cpu"), b.to("cpu")
    assert fields(edge_segments(ta)) == fields(edge_segments(tb))
    for over in ({}, {"compute_dtype": "bfloat16", "bn_mlp": True}):
        model = build_model(GSNConfig(**zinc_kwargs(d_id, **over)),
                            torch.Generator().manual_seed(0))
        assert module_shapes(model, ta) == module_shapes(model, tb)
    mol, mid = make_molhiv_like(24, seed=1)
    ogb = build_model(GSNConfig(**molhiv_kwargs(mid)),
                      torch.Generator().manual_seed(0)).eval()
    ma, mb = (batch_graphs(g, 512, 1280, 16, y_dtype=np.float32).to("cpu")
              for g in (mol[:14], mol[14:20]))
    assert ma.num_real_edges != mb.num_real_edges
    assert module_shapes(ogb, ma) == module_shapes(ogb, mb)
    dgn = make_dgn_like(24, seed=2)
    da, db = (batch_graphs(g, 512, 1280, 16, y_dtype=np.float32).to("cpu")
              for g in (dgn[:14], dgn[14:20]))
    aggs = ("mean", "max", "min", "dir0-av", "dir0-dx", "dir0-0.5")
    ca, cb = (build_agg_ctx(aggs, d, d.num_node_slots) for d in (da, db))
    skip = ("posts", "kernel_idx", "seg")
    assert [fields([v]) for k, v in ca._asdict().items() if k not in skip] \
        == [fields([v]) for k, v in cb._asdict().items() if k not in skip]
    assert not ca.W[~da.edge_mask].any()

    e = a.num_real_edges
    send = a.edge_index[1 - a.select, :e]
    order = np.argsort(send, kind="stable")
    np.testing.assert_array_equal(a.send_perm[:e], order)
    dH = torch.from_numpy(np.random.RandomState(0).randn(
        a.num_edge_slots, 5).astype(np.float32))
    ptr = torch.from_numpy(a.send_ptr)
    got = segment_sum_sorted_plain(dH, ptr, torch.from_numpy(a.send_perm))
    want = segment_sum_sorted_plain(dH[:e], ptr, torch.from_numpy(
        order.astype(np.int32)))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# scanned against looped
# ---------------------------------------------------------------------------

def run_trainer(cfg, tcfg, train, test, epochs, model=None, seed=0,
                up_front=False):
    """(epoch losses, final parameters and buffers with Adam's moments
    and steps, evaluate on train and test, epoch_stats, the host
    stream) of a CPU trainer; ``up_front`` builds each epoch's every
    batch before its first step."""
    trainer = loop.Trainer(cfg, tcfg, copy.deepcopy(train), device="cpu",
                           model=model)
    if up_front:
        lazy = trainer._train_batches
        trainer._train_batches = lambda graphs: list(lazy(graphs))
    state = trainer.init_state(seed=seed)
    losses = []
    for _ in range(epochs):
        state, loss = trainer.train_epoch(state, train)
        losses.append(loss)
    evals = [trainer.evaluate(state, split) for split in (train, test)]
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, moments in state.optimizer.state.items():
        for k, v in moments.items():
            params[f"adam.{names[id(p)]}.{k}"] = v.clone()
    return losses, params, evals, trainer.epoch_stats, trainer.rng


def assert_bit_equal(got, want):
    assert got[0] == want[0]
    assert got[1].keys() == want[1].keys()
    for k in got[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    assert got[2] == want[2]
    assert_same_stream(got[4], want[4])


def scanned_and_looped(cfg, tcfg, train, test, epochs, model=None):
    """Graphed, per step, and graphed over epochs built before their
    first step (the order of work before steps fed their own batches),
    bit for bit, each host stream where the reference's draws leave
    it."""
    out = [run_trainer(cfg, dataclasses.replace(tcfg, scan_epochs=scan),
                       train, test, epochs, copy.deepcopy(model),
                       up_front=up_front)
           for scan, up_front in ((True, False), (False, False),
                                  (True, True))]
    assert_bit_equal(out[0], out[1])
    assert_bit_equal(out[0], out[2])
    assert_same_stream(out[0][4], drawn_stream(tcfg, len(train), epochs))
    assert any(k.endswith(".exp_avg_sq") for k in out[0][1])
    stats = out[0][3]
    assert set(stats) == {"epoch_s", "steps", "host_batch_s",
                          "step_median_s", "capture_s", "step_hist",
                          "spans", *loop.TRAIN_COUNTS}
    assert stats["capture_s"] == 0.0   # no graphs on the CPU
    assert stats["train.overlapped_batches"] == 0   # nor replays
    return out


@pytest.mark.parametrize("caps_mode", ["worst", "tight"])
@pytest.mark.parametrize("num_iters", [2, None, 6],
                         ids=["short", "epoch", "wrapped"])
def test_scanned_equals_looped_zinc(zinc, caps_mode, num_iters):
    """zinc GSN-EF (d=16, 2 layers): 3 epochs of 3 batches, stopping
    short of them, at them and wrapping around them, and ``evaluate`` on
    two splits, scanned and per step, bit for bit."""
    graphs, d_id = zinc
    cfg = GSNConfig(**zinc_kwargs(d_id))
    scanned_and_looped(cfg, zinc_tcfg(num_iters=num_iters,
                                      caps_mode=caps_mode),
                       graphs[:24], graphs[24:], 3)


def test_scanned_equals_looped_molhiv():
    """molhiv GSN-VN-AF (GNN_OGB, virtual node, dropout 0.5) with BCE
    and the ``rocauc`` evaluator, scanned and per step, bit for bit."""
    graphs, d_id = make_molhiv_like(40, seed=4)
    tcfg = loop.TrainerConfig(lr=1e-3, batch_size=8, scheduler="None",
                              loss_fn="BCEWithLogitsLoss",
                              prediction_fn="None", evaluator="rocauc",
                              seed=2)
    out = scanned_and_looped(GSNConfig(**molhiv_kwargs(d_id)), tcfg,
                             graphs[:32], graphs[32:], 2)
    assert np.isfinite(out[0][2]).all()


def test_scanned_equals_looped_dgn():
    """DGNNet (the DGN CLI's seven aggregators, dropout 0.3, mean
    readout) with BCE and ``rocauc``, scanned and per step, bit for
    bit."""
    graphs = make_dgn_like(40, seed=6)
    cfg = DGNConfig(hidden_dim=16, out_dim=16, num_layers=2,
                    avg_d=compute_avg_d(graphs[:32]), dropout=0.3,
                    readout="mean", out_features=1)
    tcfg = loop.TrainerConfig(lr=1e-3, batch_size=8,
                              scheduler="ReduceLROnPlateau",
                              loss_fn="BCEWithLogitsLoss",
                              prediction_fn="None", evaluator="rocauc",
                              seed=1)
    scanned_and_looped(cfg, tcfg, graphs[:32], graphs[32:], 2,
                       model=DGNNet(cfg))


# ---------------------------------------------------------------------------
# against the reference's scanned epochs
# ---------------------------------------------------------------------------

def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


@pytest.mark.parametrize("caps_mode", ["worst", "tight"])
@pytest.mark.parametrize("num_iters", [2, None, 5],
                         ids=["short", "epoch", "wrapped"])
def test_scanned_epochs_match_reference(zinc, caps_mode, num_iters):
    """zinc GSN-EF with BN (d=16, 2 layers; MSE, whose gradient has no
    jump where a residual crosses zero, as L1's has): three scanned
    epochs of 3 batches (stopping short of them, at them, wrapping
    around them) of both packages from the same carried weights give
    the same epoch losses (rtol 2e-4 / atol 2e-5), host streams and
    parameters (rtol 2e-3, atol 1e-4 · max|p|; the biases ahead of a BN
    two lr a step more); then
    the port's scanned ``evaluate`` of the reference's trained weights
    and statistics equals the reference's (rtol 2e-4 / atol 2e-5).  (The
    noise steps of those biases reach an evaluation through the BN's
    running mean, which lags them, so each package evaluates the same
    weights.)"""
    graphs, d_id = zinc
    train, test = graphs[:24], graphs[24:]
    kw = zinc_kwargs(d_id)
    tcfg = zinc_tcfg(loss_fn="MSELoss", prediction_fn="MSELoss",
                     num_iters=num_iters, caps_mode=caps_mode)
    jt = jax_loop.Trainer(JaxConfig(**kw), jax_loop.TrainerConfig(
        **dataclasses.asdict(tcfg)), train)
    example = next(jax_batches(train, 8, caps=jt.caps))
    jstate = jt.init_state(example, seed=0)
    init = jt.init_state(example, seed=0)
    tt = loop.Trainer(GSNConfig(**kw), tcfg, copy.deepcopy(train),
                      device="cpu")
    tstate = tt.init_state(seed=0)
    load_flax_variables(tstate.model, numpy_tree(init.params),
                        numpy_tree(init.batch_stats))
    jl, tl = [], []
    for _ in range(3):
        jstate, loss = jt.train_epoch(jstate, train)
        jl.append(loss)
        tstate, loss = tt.train_epoch(tstate, train)
        tl.append(loss)
    np.testing.assert_allclose(tl, jl, **FWD)
    assert_same_stream(tt.rng, jt.rng)
    assert_same_stream(tt.rng, drawn_stream(tcfg, len(train), 3))
    steps = 3 * tt.epoch_stats["steps"]
    want = flax_to_state_dict(numpy_tree(jstate.params))
    model = tstate.model
    ahead_of_bn = {f"conv_{i}.update_fn.dense_"
                   f"{model.get_submodule(f'conv_{i}.update_fn').num_hidden}"
                   ".bias" for i in range(kw["num_layers"])}
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, ref in want.items():
        atol = 1e-4 * float(np.abs(ref).max())
        if name in ahead_of_bn:
            atol += 2 * steps * tcfg.lr
        np.testing.assert_allclose(got[name].detach().numpy(), ref,
                                   rtol=PARAM_RTOL, atol=atol, err_msg=name)
    load_flax_variables(model, numpy_tree(jstate.params),
                        numpy_tree(jstate.batch_stats))
    for split in (train, test):
        np.testing.assert_allclose(tt.evaluate(tstate, split),
                                   jt.evaluate(jstate, split), **FWD)


# ---------------------------------------------------------------------------
# the graph cache and the launch bookkeeping
# ---------------------------------------------------------------------------

def train_keys(trainer):
    return {k for k in trainer._graphs if k[0] == "train"}


def test_new_state_gets_fresh_graphs(zinc, tmp_path):
    """Each state's steps are keyed on its storage: a second
    ``init_state`` and a state loaded from a checkpoint get fresh keys
    (a replay never reaches another state's tensors), an epoch of a
    cached state adds none, evaluation keys no optimizer, and a state's
    entries go with its model."""
    graphs, d_id = zinc
    train = graphs[:24]
    trainer = loop.Trainer(GSNConfig(**zinc_kwargs(d_id)), zinc_tcfg(),
                           train, device="cpu")
    s1 = trainer.init_state(seed=0)
    s1, _ = trainer.train_epoch(s1, train)
    k1 = train_keys(trainer)
    assert len(k1) == 1
    s1, _ = trainer.train_epoch(s1, train)
    assert train_keys(trainer) == k1
    trainer.evaluate(s1, train)
    (ek,) = {k for k in trainer._graphs if k[0] == "eval"}
    assert ek[2][1] is None and ek[2][0] == id(s1.model)

    s2 = trainer.init_state(seed=0)
    s2, _ = trainer.train_epoch(s2, train)
    k2 = train_keys(trainer) - k1
    assert len(k2) == 1
    path = os.path.join(tmp_path, "ckpt.pt")
    save_checkpoint(path, s1, trainer.scheduler, trainer.rng)
    s2, _ = load_checkpoint(path, s2, trainer.scheduler, trainer.rng)
    s2, _ = trainer.train_epoch(s2, train)
    k3 = train_keys(trainer) - k1 - k2
    assert len(k3) == 1 and next(iter(k3))[2][0] == id(s2.model)

    mid = id(s1.model)
    del s1
    gc.collect()
    assert not [k for k in trainer._graphs if k[2][0] == mid]
    assert len(trainer._graphs) == 2   # s2's, before and after the load


@pytest.mark.parametrize("num_iters", [None, 5], ids=["epoch", "wrapped"])
def test_batches_built_between_steps(zinc, monkeypatch, num_iters):
    """A graphed epoch builds batch k+1 after step k is issued (a
    wrap-around step builds nothing); nothing runs ahead on the CPU, so
    ``train.overlapped_batches`` is 0, and where each step reports a
    replay launched (a stub of a captured graph) every step after the
    first counts.  ``ParallelTrainer`` still builds its whole epoch and
    checks every step's signature before its runs begin."""
    from gsn_tpu_torch.graphs import batching
    graphs, d_id = zinc
    order = []
    build_batch = batching.batch_graphs

    def recording_build(*args, **kwargs):
        order.append("build")
        return build_batch(*args, **kwargs)

    step = loop.StepGraph.step

    def recording_step(self, state):
        order.append("step")
        return step(self, state)

    monkeypatch.setattr(batching, "batch_graphs", recording_build)
    monkeypatch.setattr(loop.StepGraph, "step", recording_step)
    trainer = loop.Trainer(GSNConfig(**zinc_kwargs(d_id)),
                           zinc_tcfg(num_iters=num_iters), graphs[:24],
                           device="cpu")
    state = trainer.init_state(seed=0)
    state, _ = trainer.train_epoch(state, graphs[:24])
    steps = trainer.epoch_stats["steps"]
    assert steps == (num_iters or 3)
    assert order == ["build", "step"] * 3 + ["step"] * (steps - 3)
    assert trainer.epoch_stats["train.overlapped_batches"] == 0

    monkeypatch.setattr(loop.StepGraph, "captured", property(lambda g: True))
    trainer.train_epoch(state, graphs[:24])
    assert trainer.epoch_stats["train.overlapped_batches"] == steps - 1
    monkeypatch.undo()

    for mode in ("dp", "ep"):
        par = ParallelTrainer(GSNConfig(**zinc_kwargs(d_id)),
                              zinc_tcfg(num_iters=num_iters), graphs[:24],
                              mesh=Mesh(mode, 1, 0, torch.device("cpu")),
                              mode=mode)
        calls = []
        monkeypatch.setattr(par, "_check_runs",
                            lambda sigs: calls.append(("check", sigs)))
        monkeypatch.setattr(loop.Trainer, "_train_runs",
                            lambda self, st, seq: calls.append(
                                ("runs", seq)) or ([0.0] * len(seq), []))
        par.train_epoch(loop.Trainer.init_state(par, seed=0), graphs[:24])
        (check, sigs), (runs_, seq) = calls
        assert (check, runs_) == ("check", "runs")
        assert isinstance(seq, list) and len(seq) == steps
        assert sigs == [batch_sig(b) for b in seq]
        monkeypatch.undo()


@build.counted
def fake_kernel(mode: str, form: str, width: int):
    """A counted wrapper that launches nothing: it only counts."""
    build.count(fake_kernel, mode, form, width)


def test_replay_launch_bookkeeping():
    """What a capture records (``since``), takes back (``restore``) and
    each replay adds (``add``): launches, modes, forms and widths."""
    assert fake_kernel in build.COUNTED
    build.reset(fake_kernel)
    fake_kernel("f32", "warp", 8)            # a launch before the capture
    snap = build.snapshot()
    fake_kernel("f32", "warp", 8)            # the capture's two launches
    fake_kernel("bf16", "block", 4)
    delta = build.since(snap)
    assert delta == {fake_kernel: (2, {"f32": 1, "bf16": 1},
                                   {"warp": 1, "block": 1},
                                   {("f32", 8): 1, ("bf16", 4): 1})}
    build.restore(snap)
    assert (fake_kernel.launches, fake_kernel.modes, fake_kernel.forms,
            fake_kernel.widths) == (1, {"f32": 1}, {"warp": 1},
                                    {("f32", 8): 1})
    build.add(delta, times=3)                # three replays
    assert fake_kernel.launches == 7
    assert fake_kernel.modes == {"f32": 4, "bf16": 3}
    assert fake_kernel.forms == {"warp": 4, "block": 3}
    assert fake_kernel.widths == {("f32", 8): 4, ("bf16", 4): 3}
    assert build.since(build.snapshot()) == {}


def test_parallel_trainer_runs_per_step(zinc):
    """``ParallelTrainer`` keeps the caller's ``scan_epochs``, for the
    ranks that ``parallel.launch`` spawns (one program over the mesh, as
    the reference's ``shard_map`` scan) and for ``distributed=True``
    (separately launched processes: each still one rank building its own
    shard, so nothing stops its epochs being graphed); a caller's
    ``scan_epochs=False`` stays off."""
    graphs, d_id = zinc
    for mode in ("dp", "ep"):
        mesh = Mesh(mode, 1, 0, torch.device("cpu"))
        for scan, distributed, want in ((True, False, True),
                                        (True, True, True),
                                        (False, False, False),
                                        (False, True, False)):
            trainer = ParallelTrainer(
                GSNConfig(**zinc_kwargs(d_id)),
                zinc_tcfg(scan_epochs=scan), graphs, mesh=mesh, mode=mode,
                distributed=distributed)
            assert trainer.tcfg.scan_epochs is want, (mode, scan,
                                                      distributed)
    assert loop.TrainerConfig().scan_epochs is True
