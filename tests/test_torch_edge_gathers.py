"""The per-edge gathers' backward over the batch's segments, on the CPU.

A message that is not fused gathers node rows at every edge slot
(``A[recv]``, ``B[send]``; the ``ogb`` and ``gin`` kinds' sender rows).
With the batch's segment layout the port sums their cotangent with K3
(its plain version here) over ``recv_ptr``, and over ``send_ptr``
through ``send_perm`` (``ops/segment.py::receiver_gather`` /
``sender_gather``); without one, they are plain indexing.  Held here, on
a batch whose caps leave most edge slots padding (all at node slot 0):

- the forward is the same bits on both routes, and every parameter
  gradient agrees, for the f32 ``bn_mlp`` ``general`` model (ZINC's
  published messages), a ``general`` model with ``aggr="mean"`` and an
  ``ogb`` model with ``aggr="mean"``; against the gathers alone on plain
  indexing, and against layers given no segments at all (index gathers
  and masked ``index_add`` sums);
- the counters ``edge_gather.segment`` / ``edge_gather.index``: 2 a
  ``general`` layer on one route, 0 on the other, 0 / 0 where the
  message is fused; a train epoch's ``epoch_stats`` holds them;
- K3 is called twice a layer in the backward, once over ``recv_ptr`` and
  once over ``send_ptr`` through ``send_perm``.

Tolerances as in ``tests/test_torch_receiver_sums.py``: gradients rtol
2e-3 / atol 1e-4 * max|g|.  ``tests/test_torch_fused_bn.py`` and
``tests/test_torch_receiver_sums.py`` hold these routes to ``gsn_tpu``.
"""

import copy

import numpy as np
import pytest
import torch

from gsn_tpu_torch import spans
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import make_zinc_like
from gsn_tpu_torch.graphs.batching import iterate_batches
from gsn_tpu_torch.nn import filters, models
from gsn_tpu_torch.nn.models import build_model
from gsn_tpu_torch.ops import segment
from gsn_tpu_torch.train import loop, metrics

# 4 molecules in caps made for 16 (ZINC's last batch of an epoch: 16
# graphs under the caps of 128): most edge slots are padding
CAPS = (512, 1024, 16)
NUM_GRAPHS = 4
LAYERS = 2


def cfg_kwargs(d_id, kind):
    kw = dict(model_name="GSN_edge_sparse", num_layers=LAYERS, d_out=16,
              out_features=1, msg_kind="general", id_scope="global",
              bn_mlp=False, id_embedding="one_hot_encoder",
              input_node_encoder="embedding", edge_encoder="embedding",
              readout="sum", in_features=1, d_in_node_encoder=[28],
              d_in_edge_encoder=[4], d_in_id=d_id)
    if kind == "general-bn_mlp":
        kw["bn_mlp"] = True
    elif kind == "general-mean":
        kw["aggr"] = "mean"
    elif kind in ("ogb-mean", "ogb-add"):
        kw.update(msg_kind="ogb", id_embedding="embedding",
                  d_out_id_embedding=16, d_out_edge_encoder=16,
                  aggr="mean" if kind == "ogb-mean" else "add")
    else:
        raise ValueError(kind)
    return kw


@pytest.fixture(scope="module")
def data():
    graphs, d_id = make_zinc_like(NUM_GRAPHS)
    tb = next(iterate_batches(graphs, NUM_GRAPHS, caps=CAPS,
                              y_dtype=np.float32)).to("cpu")
    assert tb.num_real_edges < tb.num_edge_slots // 4
    return graphs, d_id, tb


def make_model(d_id, kind):
    torch.manual_seed(0)
    return build_model(GSNConfig(**cfg_kwargs(d_id, kind))).train()


def step(model, tb):
    """(prediction, {name: gradient}) of one train-mode L1 step."""
    model.zero_grad()
    out = model(tb)
    metrics.l1_loss(out, tb.y, tb.graph_mask).backward()
    return out.detach(), {n: p.grad.clone()
                          for n, p in model.named_parameters()}


def index_route(monkeypatch, route):
    """Put the per-edge gathers (``"gathers"``) or the layers
    (``"layers"``: gathers and receiver sums) on their no-segment
    route."""
    if route == "gathers":
        gather = filters.edge_gather
        monkeypatch.setattr(filters, "edge_gather",
                            lambda rows, idx, seg, side:
                            gather(rows, idx, None, side))
    else:
        monkeypatch.setattr(models, "edge_segments", lambda data: None)


@pytest.mark.parametrize("route", ["gathers", "layers"])
@pytest.mark.parametrize("kind", ["general-bn_mlp", "general-mean",
                                  "ogb-mean"])
def test_segment_gathers_match_index_route(data, monkeypatch, kind, route):
    """Both routes from one set of weights: the train-mode prediction bit
    for bit where only the gathers differ (at the f32 forward tolerance
    where the sums differ too), every parameter gradient at the gradient
    tolerances, and the BN statistics equal."""
    _graphs, d_id, tb = data
    model = make_model(d_id, kind)
    start = copy.deepcopy(model.state_dict())
    out, grads = step(model, tb)
    stats = copy.deepcopy(model.state_dict())
    model.load_state_dict(start)
    with monkeypatch.context() as m:
        index_route(m, route)
        out_i, grads_i = step(model, tb)
    if route == "gathers":
        assert torch.equal(out, out_i)
    else:
        torch.testing.assert_close(out, out_i, rtol=2e-4, atol=2e-5)
    scale = max(float(g.abs().max()) for g in grads_i.values())
    assert scale > 0
    assert set(grads) == set(grads_i)
    for name, want in grads_i.items():
        torch.testing.assert_close(grads[name], want, rtol=2e-3,
                                   atol=1e-4 * scale, msg=name)
    for name, want in model.state_dict().items():
        torch.testing.assert_close(stats[name], want, rtol=1e-4, atol=1e-5,
                                   msg=name)


# gathers a forward builds (2 layers): general, x and the ids at both
# ends of each layer; ogb, the sender rows of x in each layer and of the
# ids in layer 0 (ids are not injected later); ogb with add aggregation
# fuses its messages when it has the segments
@pytest.mark.parametrize("kind,with_seg,without_seg", [
    ("general-bn_mlp", 4, 4), ("general-mean", 4, 4), ("ogb-mean", 3, 3),
    ("ogb-add", 0, 3)])
def test_gathers_counted_by_route(data, monkeypatch, kind, with_seg,
                                  without_seg):
    """A forward counts its gathers under ``edge_gather.segment`` with the
    batch's segments and none under ``edge_gather.index``; layers given
    no segments count them the other way round."""
    _graphs, d_id, tb = data
    model = make_model(d_id, kind)
    snap = spans.snapshot()
    model(tb)
    counts = spans.since(snap)[1]
    assert counts.get("edge_gather.segment", 0) == with_seg
    assert "edge_gather.index" not in counts
    with monkeypatch.context() as m:
        index_route(m, "layers")
        snap = spans.snapshot()
        model(tb)
    counts = spans.since(snap)[1]
    assert "edge_gather.segment" not in counts
    assert counts.get("edge_gather.index", 0) == without_seg


def test_backward_sums_each_gather_with_k3(data, monkeypatch):
    """The backward of the f32 ``bn_mlp`` model calls K3 twice a layer
    for its gathers: over ``recv_ptr`` with no permutation, and over
    ``send_ptr`` through ``send_perm``, each into the rows' dtype and
    node count."""
    _graphs, d_id, tb = data
    calls = []
    k3 = segment.segment_sum_sorted

    def spy(rows, ptr, perm=None, out_dtype=torch.float32):
        calls.append((ptr, perm, rows.shape, out_dtype))
        return k3(rows, ptr, perm, out_dtype)

    monkeypatch.setattr(segment, "segment_sum_sorted", spy)
    model = make_model(d_id, "general-bn_mlp")
    out = model(tb)
    assert calls == []
    metrics.l1_loss(out, tb.y, tb.graph_mask).backward()
    assert len(calls) == 2 * LAYERS
    recv = [c for c in calls if c[1] is None]
    send = [c for c in calls if c[1] is not None]
    assert len(recv) == len(send) == LAYERS
    for ptr, perm, shape, dtype in calls:
        assert ptr is (tb.recv_ptr if perm is None else tb.send_ptr)
        assert perm is None or perm is tb.send_perm
        assert shape[0] == tb.num_edge_slots and dtype == torch.float32


def test_train_epoch_counts_gathers(data):
    """``epoch_stats`` holds the counters: a 4-layer f32 ``bn_mlp`` zinc
    model (ZINC's published messages) builds 8 gathers a step on the
    segment route, none on the index route (each step built eagerly on
    the CPU)."""
    graphs, d_id, _tb = data
    kw = cfg_kwargs(d_id, "general-bn_mlp")
    kw["num_layers"] = 4
    tcfg = loop.TrainerConfig(lr=1e-3, batch_size=2, scheduler="None",
                              loss_fn="L1Loss", prediction_fn="L1Loss",
                              seed=2)
    trainer = loop.Trainer(GSNConfig(**kw), tcfg, graphs, device="cpu")
    trainer.train_epoch(trainer.init_state(seed=0), graphs)
    st = trainer.epoch_stats
    assert st["steps"] == NUM_GRAPHS // 2
    assert st["edge_gather.segment"] == 8 * st["steps"]
    assert st["edge_gather.index"] == 0


def test_gathers_check_segment_count():
    """A segment layout over another node count than the rows is refused
    in the forward (a shape check, safe under capture)."""
    rows = torch.zeros(3, 2)
    ptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    seg = segment.EdgeSegments(ptr, torch.zeros(2, dtype=torch.int32), ptr,
                               torch.arange(2, dtype=torch.int32))
    idx = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="2 segments, 3 rows"):
        segment.receiver_gather(rows, idx, seg)
    with pytest.raises(ValueError, match="2 segments, 3 rows"):
        segment.sender_gather(rows, idx, seg)
