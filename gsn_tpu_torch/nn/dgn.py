"""Directional Graph Network (DGN) layer and model (counterpart of
``gsn_tpu/nn/dgn.py``, reference ``directional_gsn/nets/*``).

Every aggregator is a segment op over the batch's real edges in
receiver-sorted order.  The per-edge arrays (senders, receivers, the
vector field, the weight columns W) run over the batch's edge slots,
padding under ``edge_mask`` (W is zero there), so their shapes are the
caps' whatever the real edge count, as a captured CUDA graph needs.
Aggregator math (``aggregators.py:8-71``), with
vf the per-edge vector field and N(v) the in-neighbourhood:

- mean/sum/max/min/var/std: segment reductions;
- dir-av:   out_v = Σ_e w_e h_src(e),  w_e = |vf_e| / (Σ|vf| + EPS);
- dir-dx:   out_v = |Σ_e u_e h_src(e) − (Σ_e u_e) h_v|,
            u_e = vf_e / (Σ|vf| + EPS)  (discrete derivative);
- dir-dx-no-abs / dir-dx-balanced, dir-softmax: the same pattern with
  signed / balanced / softmaxed weights.

On the card the layer sends every weighted aggregator (mean, sum and
the directional ones) and max/min through the kernels of
``ops/cuda/slab_weighted.py`` and ``ops/cuda/slab_minmax.py``, with the
dispatch of the reference (``gsn_tpu/nn/dgn.py:363-399``): both kinds
present take ``dgn_fused`` (B8), weighted only ``weighted_gather`` (B5),
max/min only ``segment_minmax`` (B6).  The per-edge weights are
layer-invariant: ``build_agg_ctx`` computes them once per forward, and
their node-sum denominators in one K3 pass (``node_sums``).  var/std and
the softmax weights' denominators are K3 sums over the batch's
``recv_ptr`` too (``receiver_sum`` / ``receiver_mean``: one fixed order
per receiver, as the reference's ``jax.ops.segment_sum``); the softmax
weights' segment max stays a plain PyTorch ``scatter_reduce`` (a max is
the same in any order).

``DGNConfig.compute_dtype="bfloat16"`` follows the reference's cast
points (``gsn_tpu/nn/dgn.py:374-427, 485-488, 511-512``): node rows
travel in bf16 from after the embedding and the positional encoding on,
the kernels take them as bf16 data, the fallback aggregators gather f32
rows, the aggregators' parts are f32 and the posttrans layers compute in
bf16; BN keeps f32 statistics and returns bf16, the residual adds in
bf16, and the readout and its head are f32.  The vector field, the
aggregator weights W and their node sums stay f32, and so do the
parameters.

Scalers (``scalers.py``) are PNA log-degree scalings using train-set
averages avg_d; D is the per-node in-degree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch
from torch import nn

from gsn_tpu_torch.graphs.container import GraphBatch
from gsn_tpu_torch.ops.cuda.slab_combine import segment_sum_sorted
from gsn_tpu_torch.ops.cuda.slab_message import EdgeSegments
from gsn_tpu_torch.ops.cuda.slab_minmax import segment_minmax
from gsn_tpu_torch.ops.cuda.slab_weighted import dgn_fused, weighted_gather
from gsn_tpu_torch.ops.norm import MaskedBatchNorm
from gsn_tpu_torch.ops.segment import (global_add_pool, global_mean_pool,
                                       masked_segment_max,
                                       masked_segment_mean,
                                       masked_segment_sum, receiver_mean,
                                       receiver_sum)
from .embedding import ATOM_FEATURE_DIMS, DiscreteEmbedding
from .init import init_parameters
from .mlp import dense
from .models import NodeDropout, compute_dtype_of, dropout, edge_segments

EPS = 1e-8


# ---------------------------------------------------------------------------
# aggregators as segment ops
# ---------------------------------------------------------------------------

def _segment_min(h, dst, n, mask):
    return -masked_segment_max(-h, dst, n, mask)


def _masked(x, mask):
    return x if mask is None else torch.where(mask, x, torch.zeros_like(x))


def _dir_weights(vf_col, dst, seg_sum, signed: bool):
    """w_e = vf_e / (Σ_{e into dst} |vf_e| + EPS); |.| if not signed."""
    denom = seg_sum(vf_col.abs())
    num = vf_col if signed else vf_col.abs()
    return num / (denom[dst] + EPS)


def _softmax_alpha(kind: str) -> float:
    """'0.1' -> 0.1, 'neg-0.1' -> -0.1 (the softmax aggregator's alpha)."""
    return -float(kind[4:]) if kind.startswith("neg-") else float(kind)


def _receiver_ops(dst, num_nodes, edge_mask, recv_ptr):
    """(segment sum, segment mean) of per-edge rows at their receivers:
    K3 over ``recv_ptr`` when it is given (the rows then the real edges
    in receiver order), else masked ``index_add`` sums over ``dst``."""
    if recv_ptr is not None:
        return (lambda x: receiver_sum(x, recv_ptr),
                lambda x: receiver_mean(x, recv_ptr))
    return (lambda x: masked_segment_sum(x, dst, num_nodes, edge_mask),
            lambda x: masked_segment_mean(x, dst, num_nodes, edge_mask))


def dgn_aggregate(name: str, h_src: torch.Tensor,
                  vf: Optional[torch.Tensor], h_in: torch.Tensor,
                  dst: torch.Tensor, num_nodes: int,
                  edge_mask: Optional[torch.Tensor] = None,
                  recv_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One aggregator as plain segment ops: ``h_src`` [E, d] gathered
    source rows, ``vf`` [E, Dv] the vector field, ``h_in`` [N, d], ``dst``
    [E] receivers; ``edge_mask`` (None: every edge is real);
    ``recv_ptr``: the batch's receiver offsets, whose K3 sums then serve
    every segment sum."""
    em = edge_mask
    seg_sum, seg_mean = _receiver_ops(dst, num_nodes, em, recv_ptr)
    if name == "mean":
        return seg_mean(h_src)
    if name == "sum":
        return seg_sum(h_src)
    if name == "max":
        return masked_segment_max(h_src, dst, num_nodes, em)
    if name == "min":
        return _segment_min(h_src, dst, num_nodes, em)
    if name in ("var", "std"):
        m2 = seg_mean(h_src * h_src)
        m = seg_mean(h_src)
        var = torch.relu(m2 - m * m)
        return torch.sqrt(var + EPS) if name == "std" else var
    if not name.startswith("dir"):
        raise NotImplementedError(f"aggregator {name!r}")

    # 'dir{i}-av' | 'dir{i}-dx' | 'dir{i}-dx-no-abs' |
    # 'dir{i}-dx-balanced' | 'dir{i}-{alpha}' (softmax)
    head, kind = name.split("-", 1)
    col = vf[:, int(head[3:])]

    def wsum(w):
        return seg_sum(h_src * _masked(w, em)[:, None])

    if kind == "av":
        return wsum(_dir_weights(col, dst, seg_sum, signed=False))
    if kind in ("dx", "dx-no-abs"):
        u = _masked(_dir_weights(col, dst, seg_sum, signed=True), em)
        u_sum = seg_sum(u)
        out = wsum(u) - u_sum[:, None] * h_in
        return out.abs() if kind == "dx" else out
    if kind == "dx-balanced":
        front, back = torch.relu(col), torch.relu(-col)
        df = seg_sum(_masked(front.abs(), em))
        db = seg_sum(_masked(back.abs(), em))
        u = (front / (df[dst] + EPS) + back / (db[dst] + EPS)) / 2.0
        u = _masked(u, em)
        u_sum = seg_sum(u)
        return (wsum(u) - u_sum[:, None] * h_in).abs()
    return wsum(softmax_weight(name, vf, dst, num_nodes, em, recv_ptr))


def softmax_weight(name: str, vf, dst, num_nodes, edge_mask=None,
                   recv_ptr=None):
    """Per-edge weight of a 'dir{i}-{alpha}' softmax aggregator: a
    scalar segment max (``scatter_reduce``) and a segment sum (K3 over
    ``recv_ptr`` when given, as in ``dgn_aggregate``)."""
    head, kind = name.split("-", 1)
    logits = _softmax_alpha(kind) * vf[:, int(head[3:])].abs()
    seg_max = masked_segment_max(logits, dst, num_nodes, edge_mask)
    ex = _masked(torch.exp(logits - seg_max[dst]), edge_mask)
    seg_sum, _ = _receiver_ops(dst, num_nodes, edge_mask, recv_ptr)
    return ex / (seg_sum(ex)[dst] + EPS)


def node_sums(cols: List[torch.Tensor], seg: EdgeSegments) -> torch.Tensor:
    """[N, K'] receiver sums of K' per-edge scalar columns in one K3
    pass (the reference runs them through its edge-message kernel in
    identity mode, ``_node_sums_via_slab``; K3 computes the same
    function)."""
    return segment_sum_sorted(torch.stack(cols, dim=1).contiguous(),
                              seg.recv_ptr)


class AggContext(NamedTuple):
    """Layer-invariant aggregation context of one batch, over its edge
    slots."""
    seg: EdgeSegments
    src: torch.Tensor            # [E] int64 senders (padding: slot 0)
    dst: torch.Tensor            # [E] int64 receivers (padding: slot 0)
    em: torch.Tensor             # [E] bool, the real edges
    vf: Optional[torch.Tensor]   # [E, Dv] vector field
    deg: torch.Tensor            # [N] in-degree
    kernel_idx: List[int]        # aggregators computed as weighted sums
    W: Optional[torch.Tensor]    # [E, K] their weight columns
    posts: List[Callable]        # post(agg, h_in) for each of them


def build_agg_ctx(aggregators: Sequence[str], data: GraphBatch,
                  n: int) -> AggContext:
    """The vector field, in-degrees, and the stacked weight columns W
    [E, K] and post functions of every aggregator expressible as a
    weighted sum (one kernel pass per layer); var/std keep segment ops
    and max/min ride the minmax kernel inside the layer.  All scalar
    node-sum denominators (degree, Σ|vf_i|, Σvf_i, ...) come from ONE
    K3 pass (``node_sums``)."""
    seg = edge_segments(data)
    em = data.edge_mask
    src = seg.send.long()
    dst = data.edge_index[data.select].long()
    vf_parts = []
    if data.node_eig is not None:
        vf_parts.append(data.node_eig[src] - data.node_eig[dst])
    if data.edge_eig is not None:
        vf_parts.append(data.edge_eig)
    vf = torch.cat(vf_parts, dim=1) if vf_parts else None

    # ---- phase 1: every scalar column that needs a node sum (K3 sums
    # the real edges' rows only)
    ones = torch.ones(src.shape[0], dtype=torch.float32, device=src.device)
    cols = [ones]                     # degree
    plans = []                        # (kind, eig_idx, col slots)

    def alloc(*cs):
        i0 = len(cols)
        cols.extend(cs)
        return list(range(i0, i0 + len(cs)))

    for a in aggregators:
        if a in ("sum", "mean"):
            plans.append((a, None, None))
        elif a.startswith("dir"):
            head, kind = a.split("-", 1)
            ei = int(head[3:])
            col = vf[:, ei]
            if kind == "av":
                plans.append(("av", ei, alloc(col.abs())))
            elif kind in ("dx", "dx-no-abs"):
                plans.append((kind, ei, alloc(col.abs(), col)))
            elif kind == "dx-balanced":
                plans.append((kind, ei, alloc(torch.relu(col),
                                              torch.relu(-col))))
            else:
                plans.append(("softmax", ei, None))
        else:
            plans.append((None, None, None))   # max/min/var/std

    sums = node_sums(cols, seg)
    deg = sums[:, 0]
    inv_deg = 1.0 / torch.clamp(deg, min=1.0)
    # one [E]-gather of every per-node quantity the weights need
    sums_e = torch.cat([sums, inv_deg[:, None]], dim=1)[dst]

    # ---- phase 2: weights and posts from the node sums
    kernel_idx, kernel_w, posts = [], [], []
    for i, (a, (kind, ei, slots)) in enumerate(zip(aggregators, plans)):
        if kind is None:
            continue
        post = _identity_post
        if kind == "sum":
            w = ones
        elif kind == "mean":
            w = sums_e[:, -1]
        elif kind == "av":
            w = vf[:, ei].abs() / (sums_e[:, slots[0]] + EPS)
        elif kind in ("dx", "dx-no-abs"):
            w = vf[:, ei] / (sums_e[:, slots[0]] + EPS)
            u_sum = sums[:, slots[1]] / (sums[:, slots[0]] + EPS)
            post = _dx_post(u_sum, kind != "dx-no-abs")
        elif kind == "dx-balanced":
            df, db = sums[:, slots[0]], sums[:, slots[1]]
            col = vf[:, ei]
            w = (torch.relu(col) / (sums_e[:, slots[0]] + EPS)
                 + torch.relu(-col) / (sums_e[:, slots[1]] + EPS)) / 2.0
            post = _dx_post((df / (df + EPS) + db / (db + EPS)) / 2.0, True)
        else:
            w = softmax_weight(a, vf, dst, n, em, seg.recv_ptr)
        kernel_idx.append(i)
        kernel_w.append(w)
        posts.append(post)
    W = (_masked(torch.stack(kernel_w, dim=1), em[:, None]).contiguous()
         if kernel_idx else None)
    return AggContext(seg, src, dst, em, vf, deg, kernel_idx, W, posts)


def _identity_post(agg, h_in):
    return agg


def _dx_post(u_sum, absolute: bool):
    def post(agg, h_in):
        out = agg - u_sum[:, None] * h_in
        return out.abs() if absolute else out
    return post


def dgn_scale(name: str, h: torch.Tensor, deg: torch.Tensor,
              avg_d: Dict[str, float]) -> torch.Tensor:
    """PNA degree scalers (reference scalers.py); deg = in-degree [N]."""
    if name == "identity":
        return h
    logd = torch.log(deg + 1.0)
    if name == "amplification":
        return h * (logd / avg_d["log"])[:, None]
    if name == "attenuation":
        return h * (avg_d["log"] / torch.clamp(logd, min=EPS))[:, None]
    raise NotImplementedError(f"scaler {name!r}")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class DGNMlp(nn.Module):
    """FC stack ``fc_0 .. fc_{layers-1}``: linear -> relu between layers,
    none after the last (reference layers.py MLP); ``dtype`` is the
    compute dtype of every layer (flax ``Dense(dtype=)``)."""

    def __init__(self, d_in: int, hidden: int, out: int, layers: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers, self.dtype = layers, dtype
        widths = [d_in] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            setattr(self, f"fc_{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers - 1):
            x = torch.relu(dense(getattr(self, f"fc_{i}"), x, self.dtype))
        return dense(getattr(self, f"fc_{self.layers - 1}"), x, self.dtype)


class DGNLayerSimple(nn.Module):
    """reference dgn_layer.py:11-82 ('simple' type, the only runnable
    variant).  Submodules ``posttrans`` and ``bn`` follow the reference
    package's parameter paths.  ``dtype``: the compute dtype (None or
    ``torch.bfloat16``; the input rows are in it)."""

    def __init__(self, in_dim: int, out_dim: int,
                 aggregators: Sequence[str], scalers: Sequence[str],
                 avg_d: Dict[str, float], dropout: float = 0.0,
                 graph_norm: bool = False, batch_norm: bool = True,
                 residual: bool = True, posttrans_layers: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        self.aggregators = tuple(aggregators)
        self.scalers = tuple(scalers)
        self.avg_d = avg_d
        self.graph_norm, self.batch_norm = graph_norm, batch_norm
        self.residual = residual and in_dim == out_dim
        self.posttrans = DGNMlp(
            len(self.aggregators) * len(self.scalers) * in_dim, out_dim,
            out_dim, posttrans_layers, dtype)
        if batch_norm:
            self.bn = MaskedBatchNorm(out_dim, axis_name=bn_axis_name)
        self.dropout = NodeDropout(dropout)

    def forward(self, h: torch.Tensor, data: GraphBatch,
                ctx: AggContext, snorm: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        n, d = h.shape
        h_in = h
        parts: List[Optional[torch.Tensor]] = [None] * len(self.aggregators)
        mm_idx = [i for i, a in enumerate(self.aggregators)
                  if a in ("max", "min")]
        out = mm = None
        if ctx.kernel_idx and mm_idx:
            out, mm = dgn_fused(h, ctx.W, ctx.seg)
        elif ctx.kernel_idx:
            out = weighted_gather(h, ctx.W, ctx.seg)
        elif mm_idx:
            mm = segment_minmax(h, ctx.seg)
        for j, i in enumerate(ctx.kernel_idx):
            parts[i] = ctx.posts[j](out[:, j * d:(j + 1) * d], h_in)
        for i in mm_idx:
            parts[i] = (mm[:, :d] if self.aggregators[i] == "max"
                        else -mm[:, d:])
        h_src = None
        for i, a in enumerate(self.aggregators):
            if parts[i] is None:
                if h_src is None:
                    # f32 rows: the segment sums (var/std's E[h^2]-E[h]^2
                    # most of all) must not accumulate in bf16
                    h_src = h.float()[ctx.src]
                parts[i] = dgn_aggregate(a, h_src, ctx.vf, h_in, ctx.dst, n,
                                         ctx.em, ctx.seg.recv_ptr)
        agg = torch.cat(parts, dim=1)   # f32 parts in either dtype
        if len(self.scalers) > 1:
            agg = torch.cat([dgn_scale(s, agg, ctx.deg, self.avg_d)
                             for s in self.scalers], dim=1)

        h = self.posttrans(agg)
        if self.graph_norm:
            h = h * snorm.to(h.dtype)
        if self.batch_norm:
            h = self.bn(h, data.node_mask)
        h = torch.relu(h)
        if self.residual:
            h = h_in.to(h.dtype) + h
        return self.dropout(h, generator)


@dataclasses.dataclass
class DGNConfig:
    """The reference package's ``DGNConfig`` fields, less
    ``dropout_rng`` (the masks come from the trainer's
    ``torch.Generator``).  ``edge_feat`` and ``edge_dim`` are carried for
    the directional CLI; ``DGNNet`` reads neither, as in the reference.
    ``compute_dtype``: None (f32) or ``"bfloat16"``; ``bn_axis_name``:
    the mesh axis the layers' BN statistics are summed over (set by the
    data-parallel trainers)."""
    hidden_dim: int = 70
    out_dim: int = 70
    num_layers: int = 4
    aggregators: Tuple[str, ...] = ("mean", "max", "min",
                                    "dir0-av", "dir1-av", "dir2-av",
                                    "dir3-av")
    scalers: Tuple[str, ...] = ("identity",)
    avg_d: Optional[Dict[str, float]] = None
    readout: str = "mean"
    residual: bool = True
    edge_feat: bool = False
    edge_dim: int = 0
    in_feat_dropout: float = 0.0
    dropout: float = 0.3
    graph_norm: bool = False
    batch_norm: bool = True
    pos_enc_dim: int = 0
    posttrans_layers: int = 1
    out_features: int = 1
    compute_dtype: Optional[str] = None
    bn_axis_name: Optional[str] = None


class DGNNet(nn.Module):
    """reference dgn_net.py:8-85: AtomEncoder input, L stacked DGN-simple
    layers, sum/max/mean readout, halving-width MLPReadout head.
    Submodule names follow the reference package's parameter paths
    (``embedding_h``, ``layer_{i}``, ``readout_fc_{0,1,2}``)."""

    def __init__(self, cfg: DGNConfig):
        super().__init__()
        c = self.cfg = cfg
        if c.readout not in ("sum", "mean", "max"):
            raise ValueError(f"invalid readout {c.readout!r}")
        cdt = self.cdt = compute_dtype_of(c)
        self.embedding_h = DiscreteEmbedding(
            "atom_encoder", len(ATOM_FEATURE_DIMS), None, c.hidden_dim)
        if c.pos_enc_dim > 0:
            self.embedding_pos_enc = nn.Linear(c.pos_enc_dim, c.hidden_dim)
        avg_d = c.avg_d or {"log": 1.0}
        for i in range(c.num_layers):
            out_dim = c.out_dim if i == c.num_layers - 1 else c.hidden_dim
            setattr(self, f"layer_{i}", DGNLayerSimple(
                c.hidden_dim, out_dim, c.aggregators, c.scalers, avg_d,
                c.dropout, c.graph_norm, c.batch_norm, c.residual,
                c.posttrans_layers, cdt, c.bn_axis_name))
        widths = [c.out_dim, c.out_dim // 2, c.out_dim // 4, c.out_features]
        for l in range(3):
            setattr(self, f"readout_fc_{l}",
                    nn.Linear(widths[l], widths[l + 1]))

    def forward(self, data: GraphBatch,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        c = self.cfg
        if data.ep_axis is not None:
            raise NotImplementedError("DGN runs data-parallel, not "
                                      "edge-partitioned (as in the "
                                      "reference)")
        nm = data.node_mask
        h = self.embedding_h(data.x)
        h = dropout(h, c.in_feat_dropout, self.training, generator,
                    node_rows=True)
        if c.pos_enc_dim > 0:
            if data.node_eig is None:
                raise ValueError("pos_enc_dim > 0 needs node_eig")
            h = h + self.embedding_pos_enc(
                data.node_eig[:, 1:c.pos_enc_dim + 1])
        if self.cdt is not None:
            # node rows travel in the compute dtype between layers
            h = h.to(self.cdt)

        snorm = None
        if c.graph_norm:
            # snorm_n = sqrt(1/n_g) per node (reference HIV.py :176-178)
            sizes = data.graph_ptr.diff().to(torch.float32)
            snorm = torch.sqrt(1.0 / torch.clamp(sizes, min=1.0))[
                data.batch.long()][:, None]
        ctx = build_agg_ctx(c.aggregators, data, h.shape[0])
        for i in range(c.num_layers):
            h = getattr(self, f"layer_{i}")(h, data, ctx, snorm, generator)

        h = h.float()   # f32 readout reductions and head
        if c.readout == "sum":
            hg = global_add_pool(h, data.graph_ptr)
        elif c.readout == "max":
            hg = masked_segment_max(h, data.batch.long(),
                                    data.num_graph_slots, nm)
        else:
            hg = global_mean_pool(h, data.graph_ptr)
        y = hg
        for l in range(2):
            y = torch.relu(getattr(self, f"readout_fc_{l}")(y))
        return self.readout_fc_2(y)


def build_dgn_model(cfg: DGNConfig,
                    generator: Optional[torch.Generator] = None) -> DGNNet:
    """``DGNNet(cfg)`` on the CPU, its weights drawn from ``generator``
    (the reference package's initializers)."""
    model = DGNNet(cfg)
    init_parameters(model, generator)
    return model


def compute_avg_d(graphs: List[Dict]) -> Dict[str, float]:
    """Train-set degree statistics (reference main_HIV.py:359-363)."""
    degs = []
    for g in graphs:
        n = g["x"].shape[0]
        d = np.zeros(n)
        if g["edge_index"].size:
            np.add.at(d, g["edge_index"][1], 1.0)
        degs.append(d)
    D = np.concatenate(degs)
    return {
        "lin": float(np.mean(D)),
        "exp": float(np.mean(np.exp(1.0 / np.maximum(D, 1e-30)) - 1.0)),
        "log": float(np.mean(np.log(D + 1.0))),
    }
