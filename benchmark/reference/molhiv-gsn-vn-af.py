"""Plain reference of GSN-VN-AF on ogbg-molhiv (``GNN_OGB`` with
``GSN_edge_sparse_ogb`` layers and a virtual node; SURVEY.md §3.4):
atom and per-layer bond encoders (summed tables over OGB's 9 atom and
3 bond fields), the edge-level induced cycle counts embedded by summed
tables in layer 0, and L layers of

    h = x + vn[graph]
    x' = drop(act(BN(MLP(h + sum_j relu(h_j + id_ji + e_ji)))))
    vn' = drop(relu(MLP_vn(sum_pool(h) + vn)))        (not after the last)

where ``act`` is relu except in the last layer and ``drop`` is dropout
at ``--dropout_features``; each MLP is ``dense -> BN -> relu -> dense``
with hidden width ``--d_h``.  The prediction is a linear map of the
mean-pooled last layer, the loss BCE with logits, the metric ROC-AUC.
Dropout keeps the program's masks (``masks``: per dropout site in
forward order, node sites [nodes, d] and virtual-node sites [graphs,
d], rows in batch order), each kept entry scaled by 1/(1 - rate).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ref_common import (batch_norm, bce_loss, linear, mlp2, roc_auc,
                        sum_rows)

ATOM_DIMS = [119, 4, 12, 12, 10, 6, 6, 2, 2]
BOND_DIMS = [5, 6, 2]


def _sizes(flags):
    return (int(flags["--num_layers"]), int(flags["--d_out"]),
            int(flags["--d_h"]), float(flags["--dropout_features"]))


def spec(flags, dims):
    layers, d, d_h, _rate = _sizes(flags)
    out = []

    def tables(name, vocab, init="xavier"):
        for i, v in enumerate(vocab):
            out.append((f"{name}.MultiEmbedding_0.embed_{i}.weight", (v, d),
                        init))

    def mlp(name, d_in, d_out):
        out.extend([(f"{name}.dense_0.weight", (d_h, d_in), "lecun"),
                    (f"{name}.dense_0.bias", (d_h,), "zeros"),
                    (f"{name}.bn_0.weight", (d_h,), "ones"),
                    (f"{name}.bn_0.bias", (d_h,), "zeros"),
                    (f"{name}.dense_1.weight", (d_out, d_h), "lecun"),
                    (f"{name}.dense_1.bias", (d_out,), "zeros")])

    tables("input_node_encoder", ATOM_DIMS)
    tables("id_encoder_0", dims)
    for j in range(layers):
        tables(f"edge_encoder_{j}", BOND_DIMS)
    tables("vn_encoder", [1], "zeros")
    for i in range(layers):
        mlp(f"conv_{i}.update_fn", d, d)
        out.extend([(f"bn_{i}.weight", (d,), "ones"),
                    (f"bn_{i}.bias", (d,), "zeros")])
        if i < layers - 1:
            mlp(f"mlp_vn_{i}", d, d)
    out.extend([("lin_proj.weight", (1, d), "lecun"),
                ("lin_proj.bias", (1,), "zeros")])
    return out


def _lookup(P, name, idx):
    return sum(P[f"{name}.MultiEmbedding_0.embed_{i}.weight"][idx[:, i]]
               for i in range(idx.shape[1]))


class Model:
    def __init__(self, flags, dims):
        self.layers, self.d, _d_h, self.rate = _sizes(flags)
        self.dims = list(dims)

    def forward(self, P, stats, b, train, masks=None):
        keep = 1.0 - self.rate
        sites = iter(masks or [])

        def drop(x, rows):
            if not train or self.rate == 0.0:
                return x
            return x * next(sites)[:rows] / keep

        x = _lookup(P, "input_node_encoder", b.x)
        zeros = torch.zeros(b.num_graphs, 1, dtype=torch.long,
                            device=x.device)
        vn = _lookup(P, "vn_encoder", zeros)
        recv, send = b.dst, b.src
        ids = _lookup(P, "id_encoder_0", b.ids)
        for i in range(self.layers):
            h = x + vn[b.node_graph]
            pe = _lookup(P, f"edge_encoder_{i}", b.ef)
            if i == 0:
                pe = pe + ids
            agg = sum_rows(F.relu(h[send] + pe), recv, b.num_nodes)
            u = mlp2(h + agg, P, stats, f"conv_{i}.update_fn", train)
            x = batch_norm(u, P, stats, f"bn_{i}", train)
            if i < self.layers - 1:
                x = F.relu(x)
            x = drop(x, b.num_nodes)
            if i < self.layers - 1:
                v = mlp2(sum_rows(h, b.node_graph, b.num_graphs) + vn, P,
                         stats, f"mlp_vn_{i}", train)
                vn = drop(F.relu(v), b.num_graphs)
        n = torch.bincount(b.node_graph, minlength=b.num_graphs)
        pooled = sum_rows(x, b.node_graph, b.num_graphs) / n[:, None]
        return linear(pooled, P, "lin_proj")

    def loss(self, pred, y):
        return bce_loss(pred, y)

    def metric(self, pred, y):
        return roc_auc(y, pred)
