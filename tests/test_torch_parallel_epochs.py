"""``ParallelTrainer``'s graphed epochs on the CPU: every run of
same-shape dp or ep batches through the epoch executor (``train/
loop.py``'s runs over static buffers; the CUDA capture itself runs on
the card, ``tests/test_torch_cuda.py``) against the per-step path,
against ``gsn_tpu``'s scanned ``ParallelTrainer`` on a 2-device mesh,
the ep shards' shared edge cap and its high-water mark, and the ranks'
signature check.

The port's ranks are processes: each spawn test starts 2 gloo ranks
through ``parallel.launch`` (``torch.set_num_threads(1)``, a ``file://``
rendezvous in a temporary directory), each wait bounded by RANK_TIMEOUT_S.
The module imports no JAX at its top, so the spawned ranks, which
import it to find their functions, never load JAX; the reference runs in
this process on a 2-device mesh of the host devices
``tests/conftest.py`` provides.

Tolerances: graphed against per step, everything bit for bit (one
computation in the same order; both paths all-reduce an evaluation's
counts and metric sums in f32, as the reference's ``psum``); against
the reference, those of
``tests/test_torch_epochs.py::test_scanned_epochs_match_reference``
(losses and evaluations rtol 2e-4 / atol 2e-5, parameters rtol 2e-3 /
atol 1e-4 · max|p|), BN off, as ``tests/test_torch_parallel.py::
test_parallel_trainer_matches_single_device`` explains.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import make_zinc_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.graphs.container import pad_cap
from gsn_tpu_torch.parallel import (EdgePartitionedTrainer,
                                    ParallelTrainer, launch, make_ep_batch,
                                    make_mesh)
from gsn_tpu_torch.parallel.ep import ep_edge_slots
from gsn_tpu_torch.parallel.mesh import Mesh
from gsn_tpu_torch.params import load_flax_variables
from gsn_tpu_torch.train.graphs import batch_sig
from gsn_tpu_torch.train.loop import TrainerConfig

RANK_TIMEOUT_S = 180
FWD = dict(rtol=2e-4, atol=2e-5)
LR = 1e-3


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


def tcfg(**over):
    kw = dict(lr=LR, batch_size=8, scheduler="None", seed=3, shuffle=True,
              loss_fn="MSELoss", prediction_fn="MSELoss")
    kw.update(over)
    return TrainerConfig(**kw)


def binary(graphs):
    """The graphs with 0/1 labels as one binary task (the ROC-AUC pack)."""
    return [dict(g, y=np.array([float(g["y"] > 0)], np.float32))
            for g in graphs]


@pytest.fixture(scope="module")
def zinc():
    graphs, d_id = make_zinc_like(37, seed=4)
    return graphs, d_id


# ---------------------------------------------------------------------------
# (a) graphed against per step
# ---------------------------------------------------------------------------

def _epochs(trainer, train, test, epochs):
    """(train losses, per-batch evaluations of train and test after each
    epoch, final parameters) from ``trainer.init_state(seed=0)``; an
    evaluation is (avg loss, avg metric, per batch (loss, graphs, metric
    sum))."""
    state = trainer.init_state(seed=0)
    losses, evals = [], []
    for _ in range(epochs):
        state, loss = trainer.train_epoch(state, train)
        losses.append(loss)
        for split in (train, test):
            hosts, batches = trainer._eval_plan(split, None)
            rows = (trainer._eval_runs(state, hosts, batches)
                    if trainer.tcfg.scan_epochs
                    else trainer._eval_steps(state, batches))
            evals.append((trainer.evaluate(state, split),
                          [r[:3] for r in rows]))
    params = {k: v.detach().clone()
              for k, v in state.model.state_dict().items()}
    return losses, evals, params, state


def _graphed_rank(rank, mode, graphs, d_id):
    mesh = make_mesh(axis_names=(mode,))
    train, test = graphs[:27], graphs[27:]
    out = {}
    for scan in (True, False):
        tr = ParallelTrainer(GSNConfig(**zinc_kwargs(d_id)),
                             tcfg(scan_epochs=scan), train, mesh=mesh,
                             mode=mode)
        losses, evals, params, _ = _epochs(tr, train, test, 2)
        out[scan] = dict(losses=losses, evals=evals,
                         params={k: v.numpy() for k, v in params.items()},
                         graphs=len(tr._graphs))
    if mode == "dp":
        roc_train, roc_test = binary(train), binary(test)
        for scan in (True, False):
            tr = ParallelTrainer(
                GSNConfig(**zinc_kwargs(d_id)),
                tcfg(scan_epochs=scan, loss_fn="BCEWithLogitsLoss",
                     prediction_fn="None", evaluator="rocauc"),
                roc_train, mesh=mesh, mode=mode)
            state = tr.init_state(seed=0)
            state, _ = tr.train_epoch(state, roc_train)
            hosts, batches = tr._eval_plan(roc_test, None)
            rows = (tr._eval_runs(state, hosts, batches) if scan
                    else tr._eval_steps(state, batches))
            out[f"roc {scan}"] = dict(
                roc=tr.evaluate(state, roc_test),
                pack=[(r[3], r[4]) for r in rows])
    return out


@pytest.mark.parametrize("mode", ["dp", "ep"])
def test_graphed_epochs_equal_per_step(zinc, mode):
    """``ParallelTrainer`` on 2 gloo ranks, graphed (``scan_epochs``, the
    default) against per step on the same seed and weights, 2 epochs of
    27 graphs in batches of 8 (dp's tail batch leaves rank 1 a dummy
    shard) with BN, each evaluated on train and test: train losses,
    every parameter and BN statistic, and each eval batch's loss, graph
    count and metric sum bit for bit, and both ranks alike; under dp
    the ROC-AUC pack of a BCE evaluation
    (every rank's labels and predictions, all-gathered on the device)
    equal to the per-step path's."""
    graphs, d_id = zinc
    ranks = launch(_graphed_rank, 2, "cpu", args=(mode, graphs, d_id),
                   timeout_s=RANK_TIMEOUT_S)
    for r in ranks:
        g, p = r[True], r[False]
        assert g["graphs"] > 0 and p["graphs"] == 0
        assert g["losses"] == p["losses"] == ranks[0][True]["losses"]
        for k, v in p["params"].items():
            np.testing.assert_array_equal(g["params"][k], v, err_msg=k)
        assert g["evals"] == p["evals"] == ranks[0][True]["evals"]
        assert sum(x[1] for x in g["evals"][0][1]) == 27
    if mode == "dp":
        for r in ranks:
            got, want = r["roc True"], r["roc False"]
            assert got["roc"] == want["roc"]
            assert len(got["pack"]) == len(want["pack"]) > 1
            for (gy, gp), (wy, wp) in zip(got["pack"], want["pack"]):
                assert gy.dtype == wy.dtype
                np.testing.assert_array_equal(gy, wy)
                np.testing.assert_array_equal(gp, wp)


# ---------------------------------------------------------------------------
# (b) against the reference's scanned ParallelTrainer
# ---------------------------------------------------------------------------

def _reference_rank(rank, mode, graphs, kw, params, stats, epochs):
    mesh = make_mesh(axis_names=(mode,))
    train, test = graphs[:24], graphs[24:]
    tr = ParallelTrainer(GSNConfig(**kw), tcfg(), train, mesh=mesh,
                         mode=mode)
    assert tr.tcfg.scan_epochs
    state = tr.init_state(seed=0)
    load_flax_variables(state.model, params, stats)
    losses, evals = [], []
    for _ in range(epochs):
        state, loss = tr.train_epoch(state, train)
        losses.append(loss)
        evals.append([tr.evaluate(state, s) for s in (train, test)])
    return dict(losses=losses, evals=evals,
                params={k: v.detach().numpy()
                        for k, v in state.model.named_parameters()})


@pytest.mark.parametrize("mode", ["dp", "ep"])
def test_graphed_epochs_match_reference(zinc, mode):
    """The port's graphed epochs on 2 gloo ranks against ``gsn_tpu``'s
    ``ParallelTrainer(scan_epochs=True)`` on a 2-device mesh (its epochs
    run under ``shard_map`` scans), from the same flax weights, BN off,
    MSE (no jump in its gradient where a residual crosses zero), 2
    epochs of 24 graphs in batches of 8, each evaluated on train and
    test: epoch losses and evaluations rtol 2e-4 / atol 2e-5, parameters
    rtol 2e-3 / atol 1e-4 · max|p|."""
    import flax
    import jax
    from gsn_tpu.config import GSNConfig as JaxConfig
    from gsn_tpu.graphs.batching import iterate_batches as jax_batches
    from gsn_tpu.parallel import make_mesh as jax_make_mesh
    from gsn_tpu.parallel.trainer import ParallelTrainer as JaxParallel
    from gsn_tpu.train.loop import TrainerConfig as JaxTrainerConfig
    from gsn_tpu_torch.params import flax_to_state_dict

    def numpy_tree(tree):
        return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))

    graphs, d_id = zinc
    graphs = graphs[:32]
    train, test = graphs[:24], graphs[24:]
    kw = zinc_kwargs(d_id, bn=False)
    epochs = 2
    jt = JaxParallel(JaxConfig(**kw), JaxTrainerConfig(
        **dataclasses.asdict(tcfg())), copy.deepcopy(train),
        mesh=jax_make_mesh(2, axis_names=(mode,)), mode=mode)
    assert jt.tcfg.scan_epochs
    example = next(jax_batches(copy.deepcopy(train), 8))
    jstate = jt.init_state(example, seed=0)
    # the scan's carry holds the batch statistics as its step returns them
    # (a dict; init gives an empty FrozenDict without BN)
    jstate = jstate.replace(
        batch_stats=flax.core.unfreeze(jstate.batch_stats))
    params = numpy_tree(jstate.params)
    stats = numpy_tree(jstate.batch_stats)
    want_losses, want_evals = [], []
    for _ in range(epochs):
        jstate, loss = jt.train_epoch(jstate, copy.deepcopy(train))
        want_losses.append(loss)
        want_evals.append([jt.evaluate(jstate, copy.deepcopy(s))
                           for s in (train, test)])
    want = flax_to_state_dict(numpy_tree(jstate.params))

    ranks = launch(_reference_rank, 2, "cpu",
                   args=(mode, graphs, kw, params, stats, epochs),
                   timeout_s=RANK_TIMEOUT_S)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, **FWD)
        np.testing.assert_allclose(r["evals"], want_evals, **FWD)
        assert set(r["params"]) == set(want)
        for name, ref in want.items():
            np.testing.assert_allclose(
                r["params"][name], ref, rtol=2e-3,
                atol=1e-4 * float(np.abs(ref).max()), err_msg=name)


# ---------------------------------------------------------------------------
# (c) the ep shards' shared edge cap
# ---------------------------------------------------------------------------

def host_batches(graphs, seed=0):
    """An epoch of shuffled host batches of 8 at the worst-case caps,
    the node cap a multiple of 4 (so 2 and 4 ranks divide it)."""
    from gsn_tpu_torch.graphs.batching import epoch_caps
    n, e, g = epoch_caps(graphs, 8)
    return list(iterate_batches(graphs, 8, shuffle=True,
                                rng=np.random.RandomState(seed),
                                caps=(-(-n // 4) * 4, e, g),
                                y_dtype=np.float32))


@pytest.mark.parametrize("D", [2, 4])
def test_ep_shards_share_one_edge_cap(zinc, D):
    """Every shard of a batch has one edge slot count: ``pad_cap`` of the
    largest over the shards of its edge count and its share of the
    batch's slots, at least ``e_cap``, as the reference pads every shard
    to its largest shard's edges (``gsn_tpu/parallel/ep.py:105-112``,
    whose largest shard has as many edges on the same batch); each
    shard's real edges are those of the shard without ``e_cap``."""
    from gsn_tpu.graphs.batching import iterate_batches as jax_batches
    from gsn_tpu.parallel import make_ep_batch as jax_make_ep_batch
    graphs, _ = zinc
    for tb in host_batches(graphs):
        shards = make_ep_batch(tb, D)
        share = -(-tb.num_edge_slots // D)
        need = max(s.num_real_edges for s in shards)
        slots = pad_cap(max(need, share))
        assert {s.num_edge_slots for s in shards} == {slots}
        assert ep_edge_slots(tb, D) == slots
        for e_cap in (None, slots - 64, slots + 192):
            capped = make_ep_batch(tb, D, e_cap=e_cap)
            assert {s.num_edge_slots for s in capped} == {
                max(slots, e_cap or 0)}
            for a, b in zip(shards, capped):
                n = a.num_real_edges
                assert b.num_real_edges == n
                np.testing.assert_array_equal(b.edge_index[:, :n],
                                              a.edge_index[:, :n])
                assert not b.edge_mask[n:].any() and b.edge_mask[:n].all()
                np.testing.assert_array_equal(b.send_ptr, a.send_ptr)
                np.testing.assert_array_equal(b.recv_ptr, a.recv_ptr)
                np.testing.assert_array_equal(
                    b.send_perm, np.concatenate([
                        a.send_perm[:n],
                        np.arange(n, b.num_edge_slots)]))
    # the reference's largest shard on the same batch
    b = host_batches(graphs)[0]
    caps = (b.num_node_slots, b.num_edge_slots, b.num_graph_slots)
    jb = next(jax_batches(copy.deepcopy(graphs[:8]), 8, caps=caps,
                          y_dtype=np.float32))
    tb = next(iterate_batches(graphs[:8], 8, caps=caps, y_dtype=np.float32))
    ref = jax_make_ep_batch(jb, D, flow=tb.flow)
    assert max(s.num_real_edges for s in make_ep_batch(tb, D)) == int(
        np.asarray(ref.edge_mask).sum(axis=1).max())


def test_ep_high_water_mark_only_rises(zinc):
    """``ParallelTrainer``'s ep batches (2 ranks; no process group is
    needed to build them): within an epoch every batch has one edge slot
    count, the high-water mark ``_ep_ecap`` (reference
    ``gsn_tpu/parallel/trainer.py:110, 316-319``) never falls over epochs
    and evaluations, each epoch's count is the mark, and the two ranks'
    batches have the same signatures."""
    graphs, d_id = zinc
    trainers = [ParallelTrainer(GSNConfig(**zinc_kwargs(d_id)),
                                tcfg(caps_mode="tight"), graphs,
                                mesh=Mesh("ep", 2, r, torch.device("cpu")),
                                mode="ep") for r in range(2)]
    marks = []
    for epoch in range(4):
        sigs = []
        for tr in trainers:
            batches = (tr._train_batches(graphs) if epoch != 2
                       else tr._eval_batches(graphs[:9], None))
            assert {b.num_edge_slots for b in batches} == {tr._ep_ecap}
            sigs.append([batch_sig(b) for b in batches])
        assert sigs[0] == sigs[1]
        assert trainers[0]._ep_ecap == trainers[1]._ep_ecap
        marks.append(trainers[0]._ep_ecap)
    assert marks == sorted(marks) and marks[0] > 0


# the ep model routes (tests/test_torch_parallel.py::EP_CASES): the
# general kind's fused route, its fused-BN route, its per-edge route
# (mean aggregation), and the ogb kind
EP_CASES = {
    "fused": {},
    "bn_mlp": dict(bn_mlp=True),
    "mean": dict(aggr="mean"),
    "ogb": dict(msg_kind="ogb", id_embedding="embedding",
                d_out_id_embedding=16, d_out_edge_encoder=16),
}


def _padding_rank(rank, tb, d_id):
    mesh = make_mesh(axis_names=("ep",))
    out = {}
    base = make_ep_batch(tb, mesh.size, rank=rank)
    wide = make_ep_batch(tb, mesh.size, rank=rank,
                         e_cap=base.num_edge_slots + 256)
    assert wide.num_edge_slots == base.num_edge_slots + 256
    for name, over in EP_CASES.items():
        got = []
        for shard in (base, wide):
            ept = EdgePartitionedTrainer(GSNConfig(**zinc_kwargs(d_id,
                                                                 **over)),
                                         mesh, lr=LR, loss_fn="L1Loss")
            state = ept.init_state(seed=0)
            pred = ept.forward(state, shard)
            grads = ept.grads(state, shard)
            state, loss = ept.train_step(state, shard, LR)
            got.append(dict(pred=pred.numpy(), loss=float(loss),
                            grads={k: v.numpy() for k, v in grads.items()},
                            state={k: v.numpy() for k, v in
                                   state.model.state_dict().items()}))
        out[name] = got
    return out


def test_ep_padding_slots_carry_nothing(zinc):
    """The extra edge slots of a shared cap carry nothing: on 2 gloo
    ranks each EP_CASES model with 256 more padding slots a shard gives
    the same eval predictions and L1 loss bit for bit.  The gradients of
    the weights that act on edge rows (the edge encoders' tables, the
    edge part of the message's first dense, the per-edge MLP) are sums
    over every edge slot, whose zero rows the CPU's matrix products
    group otherwise at another row count: they, and the parameters one
    Adam step makes of them, are held to the reassociation of an f32
    sum, 1e-6 · max|v| a tensor (the largest difference seen is 4.7e-7
    of it); every other gradient, parameter and statistic bit for
    bit."""
    graphs, d_id = zinc
    tb = host_batches(graphs)[0]
    ranks = launch(_padding_rank, 2, "cpu", args=(tb, d_id),
                   timeout_s=RANK_TIMEOUT_S)
    for r in ranks:
        for name, (base, wide) in r.items():
            np.testing.assert_array_equal(wide["pred"], base["pred"],
                                          err_msg=name)
            assert wide["loss"] == base["loss"], name
            for part in ("grads", "state"):
                for k, v in base[part].items():
                    on_edges = k.startswith("edge_encoder") or (
                        ".msg_fn." in k and k.endswith(".weight"))
                    if not on_edges:
                        np.testing.assert_array_equal(
                            wide[part][k], v, err_msg=f"{name} {part} {k}")
                    np.testing.assert_allclose(
                        wide[part][k], v, rtol=0,
                        atol=1e-6 * float(np.abs(v).max()),
                        err_msg=f"{name} {part} {k}")


# ---------------------------------------------------------------------------
# (d) the ranks' signature check
# ---------------------------------------------------------------------------

def _mismatch_rank(rank, mode, graphs, d_id):
    mesh = make_mesh(axis_names=(mode,))
    tr = ParallelTrainer(GSNConfig(**zinc_kwargs(d_id)), tcfg(), graphs,
                         mesh=mesh, mode=mode)
    state = tr.init_state(seed=0)
    state, loss = tr.train_epoch(state, graphs)   # the same epochs: fine
    errors = []
    # rank 1 one batch short: its collectives would not pair up
    mine = graphs if rank == 0 else graphs[:-8]
    for call in (lambda: tr.train_epoch(state, mine),
                 lambda: tr.evaluate(state, mine)):
        try:
            call()
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    return dict(loss=loss, errors=errors)


@pytest.mark.parametrize("mode", ["dp", "ep"])
def test_signature_check_raises(zinc, mode):
    """Two ranks whose epochs (or evaluations) differ, here by a batch,
    raise before the first run on every rank, naming each rank's batch
    count and digest, rather than wait on a collective the other never
    makes; alike epochs train."""
    graphs, d_id = zinc
    ranks = launch(_mismatch_rank, 2, "cpu", args=(mode, graphs[:32], d_id),
                   timeout_s=RANK_TIMEOUT_S)
    for r in ranks:
        assert np.isfinite(r["loss"])
        assert len(r["errors"]) == 2
        for err in r["errors"]:
            assert err is not None and "batch shapes differ" in err
            assert "[4, " in err and "[3, " in err
