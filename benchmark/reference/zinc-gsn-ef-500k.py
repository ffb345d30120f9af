"""Plain reference of GSN-EF on ZINC (``GSN_edge_sparse``, ``general``
messages; SURVEY.md §3.2): 4 layers of width d, each

    m_ij = MLP_msg(cat(x_i, x_j, id_i, id_j, e_ij))     (ids in layer 0)
    x_i' = relu(BN(MLP_up(cat(x_i, sum_j m_ij))))

with one-hot atoms (28), bonds (4) and cycle-count ids, each MLP
``dense -> BN -> relu -> dense``; the prediction is the ``jk_mlp`` head
on the sum-pooled last layer, the loss L1.  Messages flow from
``edge_index[0]`` to ``edge_index[1]``.  The first message layer's
weight is kept in the program's five column blocks (receiver x, sender
x, receiver ids, sender ids, bonds), which is the same linear map.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ref_common import (batch_norm, l1_loss, linear, mlp2, sum_rows)

ATOMS, BONDS = 28, 4


def _sizes(flags):
    return int(flags["--num_layers"]), int(flags["--d_out"])


def spec(flags, dims):
    """(name, shape, init) of every parameter, in the program's names;
    ``dims``: the id columns' vocabulary sizes."""
    layers, d = _sizes(flags)
    d_id = sum(dims)
    out = []

    def dense(name, d_in, d_out, bias=True):
        out.append((f"{name}.weight", (d_out, d_in), "lecun"))
        if bias:
            out.append((f"{name}.bias", (d_out,), "zeros"))

    def bn(name, width):
        out.extend([(f"{name}.weight", (width,), "ones"),
                    (f"{name}.bias", (width,), "zeros")])

    d_x = ATOMS
    for i in range(layers):
        c = f"conv_{i}"
        parts = [d_x, d_x] + ([d_id, d_id] if i == 0 else []) + [BONDS]
        for p, width in enumerate(parts):
            dense(f"{c}.msg_fn.dense_0_p{p}", width, d, bias=False)
        out.append((f"{c}.msg_fn.dense_0_bias", (d,), "zeros"))
        bn(f"{c}.msg_fn.bn_0", d)
        dense(f"{c}.msg_fn.dense_1", d, d, bias=False)
        out.append((f"{c}.msg_fn.dense_1_bias", (d,), "zeros"))
        dense(f"{c}.update_fn.dense_0", d_x + d, d)
        bn(f"{c}.update_fn.bn_0", d)
        dense(f"{c}.update_fn.dense_1", d, d)
        bn(f"bn_{i}", d)
        d_x = d
    head = f"lin_proj_{layers}"
    dense(f"{head}.dense_0", d, d)
    bn(f"{head}.bn_0", d)
    dense(f"{head}.dense_1", d, 1)
    return out


class Model:
    def __init__(self, flags, dims):
        self.layers, self.d = _sizes(flags)
        self.dims = list(dims)

    def forward(self, P, stats, b, train, masks=None):
        x = F.one_hot(b.x[:, 0], ATOMS).float()
        ids = torch.cat([F.one_hot(b.ids[:, c], n).float()
                         for c, n in enumerate(self.dims)], 1)
        ef = F.one_hot(b.ef[:, 0], BONDS).float()
        recv, send = b.dst, b.src
        for i in range(self.layers):
            c = f"conv_{i}"
            w = [P[f"{c}.msg_fn.dense_0_p{p}.weight"]
                 for p in range(5 if i == 0 else 3)]
            h = x[recv] @ w[0].t() + x[send] @ w[1].t()
            if i == 0:
                h = h + ids[recv] @ w[2].t() + ids[send] @ w[3].t()
            h = h + ef @ w[-1].t() + P[f"{c}.msg_fn.dense_0_bias"]
            h = F.relu(batch_norm(h, P, stats, f"{c}.msg_fn.bn_0", train))
            m = linear(h, P, f"{c}.msg_fn.dense_1", bias=False) \
                + P[f"{c}.msg_fn.dense_1_bias"]
            agg = sum_rows(m, recv, b.num_nodes)
            u = mlp2(torch.cat([x, agg], 1), P, stats, f"{c}.update_fn",
                     train)
            x = F.relu(batch_norm(u, P, stats, f"bn_{i}", train))
        pooled = sum_rows(x, b.node_graph, b.num_graphs)
        return mlp2(pooled, P, stats, f"lin_proj_{self.layers}", train)

    def loss(self, pred, y):
        return l1_loss(pred, y)

    def metric(self, pred, y):
        """The split's MAE."""
        return float(abs(pred.reshape(-1) - y).mean())
