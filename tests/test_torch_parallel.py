"""The port's parallel layer (``gsn_tpu_torch/parallel``) against the
reference package's, on the CPU.

The port's ranks are processes: each test spawns its ranks once
(``parallel.launch``: 2 gloo ranks, ``torch.set_num_threads(1)``, a
``file://`` rendezvous in a temporary directory, a 120 s join timeout)
and runs several checks in them.  The reference runs in this process on
a 2-device mesh of the host devices ``tests/conftest.py`` provides.
Graphs come from the port's generators; weights from the reference's
``init`` through the weight bridge.  The module imports no JAX at its
top, so the spawned ranks, which import it to find their functions,
never load JAX.

Tolerances: forward rtol 2e-4 / atol 2e-5 and gradients rtol 2e-3 /
atol 1e-4·max|g| (tests/test_mxu_integration.py:48,79-84); bf16 kernel
outputs as tests/test_torch_bf16.py; losses and trainer epochs as the
reference's own parallel tests (tests/test_ep_model.py,
tests/test_parallel.py, tests/test_parallel_trainer.py,
tests/test_dgn_parallel.py).  Per receiver a shard walks the same edges
in the same order as the whole batch, so K1's stacked shard outputs
equal the unpartitioned call bit for bit.
"""

import copy
import os

import numpy as np
import pytest
import torch

from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import make_dgn_like, make_zinc_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.nn.dgn import DGNConfig, DGNNet, compute_avg_d
from gsn_tpu_torch.nn.models import DropoutStreams, NodeDropout, dropout
from gsn_tpu_torch.ops.cuda import slab_message as k12
from gsn_tpu_torch.parallel import (DataParallelTrainer,
                                    EdgePartitionedTrainer,
                                    ParallelTrainer, launch, make_ep_batch,
                                    make_global_batch, make_mesh)
from gsn_tpu_torch.parallel.dp import dp_shard
from gsn_tpu_torch.parallel.mesh import Mesh
from gsn_tpu_torch.params import load_flax_variables
from gsn_tpu_torch.train.loop import Trainer, TrainerConfig

CAPS = (512, 1024, 16)
NUM_GRAPHS = 16
LR = 1e-3
FWD = dict(rtol=2e-4, atol=2e-5)


def zinc_kwargs(d_id, **over):
    """bench.py::zinc_cfg at d=16 and 2 layers (BN on)."""
    kw = dict(model_name="GSN_edge_sparse", num_layers=2, d_out=16,
              out_features=1, msg_kind="general", id_scope="global",
              bn_mlp=False, id_embedding="one_hot_encoder",
              input_node_encoder="embedding", edge_encoder="embedding",
              readout="sum", in_features=1, d_in_node_encoder=[28],
              d_in_edge_encoder=[4], d_in_id=d_id)
    kw.update(over)
    return kw


# the model configurations under edge partitioning: the general kind's
# fused route, its fused-BN route (f32 id_sq under ep), its per-edge
# route (mean aggregation), and the ogb kind (additive message)
EP_CASES = {
    "fused": {},
    "bn_mlp": dict(bn_mlp=True),
    "mean": dict(aggr="mean"),
    "ogb": dict(msg_kind="ogb", id_embedding="embedding",
                d_out_id_embedding=16, d_out_edge_encoder=16),
}


def assert_grads_close(got, want, what=""):
    scale = max(float(np.max(np.abs(v))) for v in want.values())
    assert set(got) == set(want), what
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=2e-3,
                                   atol=1e-4 * scale,
                                   err_msg=f"{what} {name}")


def numpy_tree(tree):
    import flax
    import jax
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


@pytest.fixture(scope="module")
def zinc():
    graphs, d_id = make_zinc_like(NUM_GRAPHS)
    return graphs, d_id


def host_batches(graphs, caps=CAPS):
    """The port's and the reference's batch of ``graphs``."""
    from gsn_tpu.graphs.batching import iterate_batches as jax_batches
    tb = next(iterate_batches(graphs, len(graphs), caps=caps,
                              y_dtype=np.float32))
    jb = next(jax_batches(copy.deepcopy(graphs), len(graphs), caps=caps,
                          y_dtype=np.float32))
    return tb, jb


# ---------------------------------------------------------------------------
# make_ep_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 4])
def test_make_ep_batch_matches_reference(zinc, D):
    """Per shard: the same (local receiver, global sender) pairs in the
    same order, the same node blocks, edge rows and replicated graph
    arrays as ``gsn_tpu.parallel.ep.make_ep_batch``; the segment layout
    agrees with them; a node cap that D does not divide raises."""
    from gsn_tpu.parallel import make_ep_batch as jax_make_ep_batch
    graphs, _ = zinc
    tb, jb = host_batches(graphs)
    ref = jax_make_ep_batch(jb, D, flow=tb.flow)
    shards = make_ep_batch(tb, D)
    block = CAPS[0] // D
    counts = np.zeros(tb.num_graph_slots, np.int64)
    for d, s in enumerate(shards):
        assert s.ep_axis == "ep" and s.num_node_slots == block
        n = s.num_real_edges
        assert n == int(np.asarray(ref.edge_mask[d]).sum())
        assert s.edge_mask.sum() == n and not s.edge_mask[n:].any()
        np.testing.assert_array_equal(s.edge_index[:, :n],
                                      np.asarray(ref.edge_index[d])[:, :n])
        np.testing.assert_array_equal(s.edge_features[:n],
                                      np.asarray(ref.edge_features[d])[:n])
        for name in ("x", "batch", "node_mask", "degrees", "identifiers",
                     "y", "graph_mask"):
            np.testing.assert_array_equal(
                getattr(s, name), np.asarray(getattr(ref, name)[d]),
                err_msg=name)
        recv, send = s.edge_index[0, :n], s.edge_index[1, :n]
        np.testing.assert_array_equal(
            s.recv_ptr, np.concatenate([[0], np.cumsum(
                np.bincount(recv, minlength=block))]))
        np.testing.assert_array_equal(s.in_degree,
                                      np.bincount(recv, minlength=block))
        assert s.send_ptr.shape == (CAPS[0] + 1,)
        np.testing.assert_array_equal(np.diff(s.send_ptr),
                                      np.bincount(send, minlength=CAPS[0]))
        np.testing.assert_array_equal(send[s.send_perm], np.sort(send))
        counts += np.diff(s.graph_ptr)
    # the clipped graph offsets split every graph's nodes over the blocks
    np.testing.assert_array_equal(counts, np.diff(tb.graph_ptr))
    with pytest.raises(ValueError, match="not divisible"):
        make_ep_batch(tb, 3)


# ---------------------------------------------------------------------------
# K1/K2/K3 in the split mode (the reference's num_send_nodes)
# ---------------------------------------------------------------------------

def bf16_close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=1e-2 * float(np.abs(want).max(
                                   initial=0.0)),
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_mode_kernels_match_reference(zinc, dtype):
    """At D=4 shard shapes, K1/K2's plain versions with B in the
    gathered sender space and dB by K3 over the global ``send_ptr``,
    through ``EdgeMessageAggregate``, against ``gsn_tpu``'s
    ``slab_edge_message_aggregate`` with ``num_send_nodes`` (interpret
    mode) on the reference's own shards: forward, dA, dB, dPe, db1.
    The shards' stacked outputs equal the unpartitioned call bit for
    bit, and their dB summed equals its dB."""
    import jax
    import jax.numpy as jnp
    from gsn_tpu.ops.pallas.slab_message import (S_R, S_S,
                                                 slab_edge_message_aggregate)
    from gsn_tpu.parallel import make_ep_batch as jax_make_ep_batch
    from gsn_tpu_torch.nn.models import edge_segments

    D, d = 4, 16
    graphs, _ = zinc
    tb, jb = host_batches(graphs)
    slab = {"mode": "slab", "block_n": 128, "block_e": 256}
    ref = jax_make_ep_batch(jb, D, flow=tb.flow, mxu_layout=slab)
    assert ref.seg_mode == "slab"
    shards = make_ep_batch(tb, D)
    N, E = CAPS[0], tb.num_real_edges
    block, bn, be = N // D, 128, 256
    pad_recv = max(-(-block // bn), S_R) * bn
    pad_send = max(-(-N // bn), S_S) * bn
    rng = np.random.RandomState(3)
    A, B = (rng.randn(N, d).astype(np.float32) for _ in range(2))
    Pe = rng.randn(E, d).astype(np.float32) * 0.1
    b1 = rng.randn(d).astype(np.float32)
    g = rng.randn(N, d).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def run(seg, A_, Pe_, g_):
        leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True)
                  for x in (A_, B, Pe_)] + [
            torch.from_numpy(b1).requires_grad_(True)]
        out = k12.edge_message_aggregate(*leaves, seg, "relu")
        (out.float() * torch.from_numpy(g_)).sum().backward()
        return out.detach(), [x.grad for x in leaves]

    whole, whole_grads = run(edge_segments(tb.to("cpu")), A, Pe, g)
    stacked, dB_sum = [], torch.zeros(N, d)
    e0 = 0
    for s_ in range(D):
        shard = shards[s_].to("cpu")
        lo, hi = s_ * block, (s_ + 1) * block
        n = shard.num_real_edges
        pe_d = Pe[e0:e0 + n]
        out, (dA, dB, dPe, db1) = run(edge_segments(shard), A[lo:hi],
                                      pe_d, g[lo:hi])
        stacked.append(out)
        dB_sum += dB.float()

        C = ref.seg_chunks.shape[-1]
        pe_ref = np.zeros((C * be, d), np.float32)
        pe_ref[:n] = pe_d

        def fn(A_, B_, Pe_, b_):
            return slab_edge_message_aggregate(
                A_, B_, Pe_, b_, jnp.asarray(ref.seg_recv_local[s_]),
                jnp.asarray(ref.seg_send_local[s_]),
                jnp.asarray(ref.seg_chunks[s_][:2]), block, pad_recv, bn,
                be, "relu", True, True, pad_send, dtype, True,
                ref.seg_s_s)[:block]

        args = (jnp.asarray(A[lo:hi], jdt), jnp.asarray(B, jdt),
                jnp.asarray(pe_ref, jdt), jnp.asarray(b1))
        want = fn(*args)
        wg = jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32)
                                         * g[lo:hi]),
                      argnums=(0, 1, 2, 3))(*args)
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD)
            for name, got_, w in (("dA", dA, wg[0]), ("dB", dB, wg[1]),
                                  ("dPe", dPe, np.asarray(wg[2])[:n])):
                np.testing.assert_allclose(
                    got_.numpy(), np.asarray(w), rtol=2e-3,
                    atol=1e-4 * float(np.abs(np.asarray(w)).max(
                        initial=0.0)),
                    err_msg=name)
        else:
            bf16_close(out, want, "forward")
            bf16_close(dA, wg[0], "dA")
            bf16_close(dB, wg[1], "dB")
            np.testing.assert_array_equal(
                dPe.float().numpy(),
                np.asarray(wg[2].astype(jnp.float32))[:n])
        np.testing.assert_allclose(db1.numpy(), np.asarray(wg[3]),
                                   rtol=2e-3, atol=1e-4 * float(
                                       np.abs(np.asarray(wg[3])).max()))
        e0 += n
    assert e0 == E
    assert torch.equal(torch.cat(stacked), whole)
    want_dB = whole_grads[1].float()
    np.testing.assert_allclose(
        dB_sum.numpy(), want_dB.numpy(), rtol=2e-3,
        atol=(1e-4 if dtype == "float32" else 1e-2)
        * float(want_dB.abs().max()))


def test_split_mode_shape_checks_raise():
    """A sender id past B's rows, a negative one, or a ``send_ptr`` that
    is not B's row count raise ValueError: before this check the plain
    version failed inside its gather (IndexError) and the card's kernel
    read past B."""
    ptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    B = torch.ones(4, 3)
    b1 = torch.zeros(3)
    g = torch.ones(2, 3)
    for send in (torch.tensor([0, 4, 1], dtype=torch.int32),
                 torch.tensor([0, -1, 1], dtype=torch.int32)):
        with pytest.raises(ValueError, match="sender ids"):
            k12.edge_message_fwd(None, B, None, b1, ptr, send)
        with pytest.raises(ValueError, match="sender ids"):
            k12.edge_message_bwd_recv(None, B, None, b1, g, ptr, send)
    send = torch.tensor([0, 3, 1], dtype=torch.int32)
    seg = k12.EdgeSegments(ptr, send, torch.zeros(4, dtype=torch.int32),
                           torch.argsort(send).to(torch.int32))
    with pytest.raises(ValueError, match="send_ptr has 3 segments"):
        k12.edge_message_aggregate(None, B, None, b1, seg)
    # B of more rows than receivers (the gathered sender space) is fine
    out = k12.edge_message_fwd(None, B, None, b1, ptr, send, "identity")
    assert out.shape == (2, 3)


# ---------------------------------------------------------------------------
# the edge-partitioned model
# ---------------------------------------------------------------------------

def _ep_rank(rank, tb, cases):
    mesh = make_mesh(axis_names=("ep",))
    shard = make_ep_batch(tb, mesh.size, rank=rank)
    out = {}
    for name, (kw, params, stats) in cases.items():
        ept = EdgePartitionedTrainer(GSNConfig(**kw), mesh, lr=LR,
                                     loss_fn="L1Loss")
        state = ept.init_state(seed=0)
        load_flax_variables(state.model, params, stats)
        pred = ept.forward(state, shard)
        grads = ept.grads(state, shard)
        load_flax_variables(state.model, params, stats)
        state, loss = ept.train_step(state, shard, LR)
        out[name] = dict(
            pred=pred.numpy(), loss=float(loss),
            grads={k: v.numpy() for k, v in grads.items()},
            state={k: v.numpy() for k, v in
                   state.model.state_dict().items()})
    return out


def test_ep_model_matches_reference(zinc):
    """Each EP_CASES model on 2 edge-partitioned gloo ranks against
    ``gsn_tpu``'s EdgePartitionedTrainer on a 2-device mesh: the eval
    predictions, every gradient of the L1 loss, one Adam step's loss,
    parameters (where the gradient is not numerically 0) and running BN
    statistics; both ranks agree bit for bit."""
    import jax
    from gsn_tpu.config import GSNConfig as JaxConfig
    from gsn_tpu.parallel import EdgePartitionedTrainer as JaxEPT
    from gsn_tpu.parallel import make_ep_batch as jax_make_ep_batch
    from gsn_tpu.parallel import make_mesh as jax_make_mesh
    from gsn_tpu_torch.params import flax_to_state_dict

    graphs, d_id = zinc
    tb, jb = host_batches(graphs)
    mesh = jax_make_mesh(2, axis_names=("ep",))
    ep_batch = jax_make_ep_batch(jb, 2, flow=tb.flow)
    key = jax.random.PRNGKey(5)
    cases, want = {}, {}
    for name, over in EP_CASES.items():
        kw = zinc_kwargs(d_id, **over)
        ept = JaxEPT(JaxConfig(**kw), mesh, lr=LR, loss_fn="L1Loss")
        state = ept.init_state(ep_batch, seed=0)
        params = numpy_tree(state.params)
        stats = numpy_tree(state.batch_stats)
        cases[name] = (kw, params, stats)
        new, loss = ept.train_step(state, ep_batch, LR, key)
        want[name] = dict(
            pred=np.asarray(ept.forward(state, ep_batch)),
            grads=flax_to_state_dict(numpy_tree(ept.grads(state,
                                                          ep_batch))),
            loss=float(loss),
            state=flax_to_state_dict(numpy_tree(new.params),
                                     numpy_tree(new.batch_stats)))
    ranks = launch(_ep_rank, 2, "cpu", args=(tb, cases))
    for name in EP_CASES:
        got, ref = ranks[0][name], want[name]
        np.testing.assert_array_equal(got["pred"], ranks[1][name]["pred"])
        assert got["loss"] == ranks[1][name]["loss"]
        np.testing.assert_allclose(got["pred"], ref["pred"], **FWD,
                                   err_msg=name)
        assert_grads_close(got["grads"], ref["grads"], name)
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        for k, w in ref["state"].items():
            grad = ref["grads"].get(k)
            m = (np.abs(grad) > 1e-5 if grad is not None
                 else np.ones(w.shape, bool))
            np.testing.assert_allclose(got["state"][k][m], w[m], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {k}")


def test_ep_node_dropout_streams():
    """Under edge partitioning each rank draws its node masks from its
    own stream (the ranks' masks differ, each iid at the keep rate) and
    its graph-level masks from the shared one (the ranks' masks agree)."""
    cfg = GSNConfig(**zinc_kwargs(4))
    node, graph = [], []
    for rank in range(4):
        mesh = Mesh(axis="ep", size=4, rank=rank, device=torch.device("cpu"))
        streams = DropoutStreams(*EdgePartitionedTrainer(
            cfg, mesh).generators(1))
        drop = NodeDropout(0.5).train()
        x = torch.ones(256, 16)
        node.append(drop(x, streams) != 0)
        graph.append(dropout(x, 0.5, True, streams) != 0)
    assert len({m.numpy().tobytes() for m in node}) == 4
    masks = torch.stack(node).float()
    assert abs(float(masks.mean()) - 0.5) < 0.02
    assert all(torch.equal(m, graph[0]) for m in graph[1:])
    assert abs(float(graph[0].float().mean()) - 0.5) < 0.05


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def _dp_rank(rank, graphs, kw, params, stats, caps, tail_caps):
    mesh = make_mesh(axis_names=("dp",))
    dpt = DataParallelTrainer(GSNConfig(**kw), mesh, lr=LR,
                              loss_fn="L1Loss")
    state = dpt.init_state(seed=0)
    shard = make_global_batch(graphs, mesh.size, *caps,
                              y_dtype=np.float32, rank=rank)
    load_flax_variables(state.model, params, stats)
    grads = dpt.grads(state, shard)
    load_flax_variables(state.model, params, stats)
    state, loss = dpt.train_step(state, shard, LR)
    # the tail batch: one graph, so rank 1 takes an all-padding shard
    load_flax_variables(state.model, params, stats)
    tail = dp_shard(graphs[:1], rank, mesh.size, tail_caps,
                    y_dtype=np.float32)
    _, tail_loss = dpt.train_step(state, tail, LR)
    return dict(grads={k: v.numpy() for k, v in grads.items()},
                loss=float(loss), tail_loss=float(tail_loss),
                tail_real=int(tail.graph_mask.sum()))


def test_dp_matches_reference(zinc):
    """The global loss and its gradients on 2 data-parallel gloo ranks
    against ``gsn_tpu``'s DataParallelTrainer on a 2-device mesh; the
    tail batch with a dummy shard gives the single-device loss."""
    import jax
    from gsn_tpu.config import GSNConfig as JaxConfig
    from gsn_tpu.parallel import DataParallelTrainer as JaxDPT
    from gsn_tpu.parallel import make_global_batch as jax_global_batch
    from gsn_tpu.parallel import make_mesh as jax_make_mesh
    from gsn_tpu_torch.nn.models import build_model
    from gsn_tpu_torch.params import flax_to_state_dict
    from gsn_tpu_torch.train import metrics

    graphs, d_id = zinc
    kw = zinc_kwargs(d_id)
    caps, tail_caps = (256, 512, 8), (64, 128, 8)
    dpt = JaxDPT(JaxConfig(**kw), jax_make_mesh(2, axis_names=("dp",)),
                 lr=LR, loss_fn="L1Loss")
    gb = jax_global_batch(copy.deepcopy(graphs), 2, *caps,
                          y_dtype=np.float32)
    state = dpt.init_state(gb, seed=0)
    params, stats = numpy_tree(state.params), numpy_tree(state.batch_stats)
    want = flax_to_state_dict(numpy_tree(dpt.grads(state, gb)))
    _, want_loss = dpt.train_step(state, gb, LR, jax.random.PRNGKey(7))

    ranks = launch(_dp_rank, 2, "cpu",
                   args=(graphs, kw, params, stats, caps, tail_caps))
    for r in ranks:
        assert r["loss"] == ranks[0]["loss"]
        assert_grads_close(r["grads"], want, "dp")
    np.testing.assert_allclose(ranks[0]["loss"], float(want_loss),
                               rtol=2e-4)

    # the tail: rank 1's shard is all padding
    assert [r["tail_real"] for r in ranks] == [1, 0]
    model = build_model(GSNConfig(**kw))
    load_flax_variables(model, params, stats)
    single = next(iterate_batches(graphs[:1], 1, caps=tail_caps,
                                  y_dtype=np.float32)).to("cpu")
    s_loss = float(metrics.l1_loss(model.train()(single).detach(), single.y,
                                   single.graph_mask))
    for r in ranks:
        np.testing.assert_allclose(r["tail_loss"], s_loss, rtol=1e-4)


# ---------------------------------------------------------------------------
# ParallelTrainer against the single-device Trainer
# ---------------------------------------------------------------------------

def tcfg(**over):
    kw = dict(lr=LR, batch_size=8, scheduler="None", num_epochs=3, seed=0,
              shuffle=True, loss_fn="L1Loss", prediction_fn="None")
    kw.update(over)
    return TrainerConfig(**kw)


def _roc_graphs(graphs):
    """The graphs with their 0/1 labels as one binary task."""
    return [dict(g, y=np.array([float(g["y"])], np.float32))
            for g in graphs]


def _dgn_cfg(avg_d, axis=None):
    return DGNConfig(hidden_dim=16, out_dim=16, num_layers=2,
                     aggregators=("mean", "max", "min", "dir1-av",
                                  "dir1-dx"),
                     avg_d=avg_d, dropout=0.0, out_features=1,
                     bn_axis_name=axis)


def _dgn_tcfg():
    return tcfg(scheduler="ReduceLROnPlateau", patience=3,
                loss_fn="BCEWithLogitsLoss", evaluator="rocauc",
                shuffle=False)


def _fit_tcfg():
    return tcfg(lr=1e-2)


def _roc_tcfg():
    return tcfg(loss_fn="BCEWithLogitsLoss", evaluator="rocauc")


def _trainer_runs(make, graphs, test, fit=False):
    """(eval of the fresh state, one epoch's mean loss, and with ``fit``
    a 3-epoch fit's history) of trainers ``make()``."""
    tr = make()
    st = tr.init_state(seed=0)
    out = dict(eval=tr.evaluate(st, graphs))
    out["epoch"] = tr.train_epoch(st, graphs)[1]
    if fit:
        tr = make()
        out["hist"] = tr.fit(tr.init_state(seed=0), graphs, test,
                             log_fn=None)[1]
    return out


def _trainer_rank(rank, graphs, test, kw, nobn_kw, roc, dgn_graphs, avg_d):
    out = {}
    for mode in ("dp", "ep"):
        mesh = make_mesh(axis_names=(mode,))
        for tag, kw_, tc, fit in (("", kw, tcfg(), False),
                                  ("_fit", nobn_kw, _fit_tcfg(), True)):
            out[mode + tag] = _trainer_runs(
                lambda: ParallelTrainer(GSNConfig(**kw_), tc, graphs,
                                        mesh=mesh, mode=mode),
                graphs, test, fit)
    mesh = make_mesh(axis_names=("dp",))
    tr = ParallelTrainer(GSNConfig(**kw), _roc_tcfg(), roc, mesh=mesh,
                         mode="dp")
    out["roc"] = tr.evaluate(tr.init_state(seed=0), roc)
    out["dgn"] = _trainer_runs(
        lambda: ParallelTrainer(_dgn_cfg(avg_d, "dp"), _dgn_tcfg(),
                                dgn_graphs, mesh=mesh, mode="dp",
                                model=DGNNet(_dgn_cfg(avg_d, "dp"))),
        dgn_graphs, None)
    return out


def test_parallel_trainer_matches_single_device():
    """``ParallelTrainer`` on 2 gloo ranks, dp and ep, against the
    port's single-device ``Trainer`` on the same batches (25 graphs in
    batches of 8, so dp's tail batch leaves rank 1 a dummy shard):
    evaluate on the fresh state, one epoch's mean loss, and a 3-epoch
    ``fit``'s history (without BN, whose biases take noise-driven Adam
    steps); the ROC-AUC pack of a BCE evaluation under dp; and the DGN
    model under dp with ``bn_axis_name``."""
    graphs, d_id = make_zinc_like(33, seed=2)
    graphs, test = graphs[:25], graphs[25:]
    kw = zinc_kwargs(d_id)
    nobn_kw = zinc_kwargs(d_id, bn=False)
    roc = _roc_graphs(graphs)
    dgn_graphs = make_dgn_like(28, seed=2)
    avg_d = compute_avg_d(dgn_graphs)

    ranks = launch(_trainer_rank, 2, "cpu",
                   args=(graphs, test, kw, nobn_kw, roc, dgn_graphs, avg_d))

    def single(cfg, tc, data, model=None, fit=False):
        return _trainer_runs(
            lambda: Trainer(cfg, tc, data, device="cpu", model=model),
            data, test, fit)

    s = single(GSNConfig(**kw), tcfg(), graphs)
    s_fit = single(GSNConfig(**nobn_kw), _fit_tcfg(), graphs, fit=True)
    s_roc = Trainer(GSNConfig(**kw), _roc_tcfg(), roc, device="cpu")
    s_roc = s_roc.evaluate(s_roc.init_state(seed=0), roc)
    s_dgn = single(_dgn_cfg(avg_d), _dgn_tcfg(), dgn_graphs,
                   model=DGNNet(_dgn_cfg(avg_d)))
    for r in ranks:
        for mode in ("dp", "ep"):
            np.testing.assert_allclose(r[mode]["eval"], s["eval"],
                                       rtol=1e-5, err_msg=mode)
            np.testing.assert_allclose(r[mode]["epoch"], s["epoch"],
                                       rtol=1e-4, err_msg=mode)
            got, want = r[mode + "_fit"]["hist"], s_fit["hist"]
            for key in ("train_losses", "test_losses"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                           err_msg=f"{mode} {key}")
            assert got["train_losses"][-1] < got["train_losses"][0]
        np.testing.assert_allclose(r["roc"], s_roc, rtol=1e-5)
        np.testing.assert_allclose(r["dgn"]["epoch"], s_dgn["epoch"],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["dgn"]["eval"], s_dgn["eval"],
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_parallel_matches_serial(tmp_path):
    """``python -m gsn_tpu_torch.cli --device cpu --parallel dp`` and
    ``--parallel ep`` with ``--parallel_devices 2`` on the ZINC fixture
    (BN off, for the reason given above): finite histories equal to the
    serial run's; only rank 0 writes (one log, one checkpoint)."""
    from test_torch_cli import run, zinc_argv
    from test_zinc_pipeline import make_zinc_fixture

    root = str(tmp_path)
    make_zinc_fixture(root)
    base = ("--bn", "False", "--bn_mlp", "False")
    serial = run(zinc_argv(root, *base))[0]
    for mode in ("dp", "ep"):
        hist = run(zinc_argv(root, *base, "--parallel", mode,
                             "--parallel_devices", "2",
                             "--results_folder", mode))[0]
        for key in serial:
            assert np.isfinite(hist[key]).all(), key
            np.testing.assert_allclose(hist[key], serial[key], rtol=1e-5,
                                       err_msg=f"{mode} {key}")
        run_dir = os.path.join(root, "cache", "results", mode, "-1",
                               "GSN_edge_sparse")
        assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) \
            == ["checkpoint.pt"]
        recs = open(os.path.join(run_dir, "log.jsonl")).read().splitlines()
        assert sum('"train_loss"' in r for r in recs) == 2
