"""Work of GSN-VN-AF on ogbg-molhiv as functions of a set's real rows:
N nodes, E directed edges, G graphs; d the width, h the MLPs' hidden
width, L the layers, f32.

``model_flops``: the matrix products of the forward (a dense layer of k
inputs and n outputs on m rows is 2·m·k·n): each layer's update MLP,
the virtual node's MLPs between layers, the prediction; table lookups
and the ogb message (sums and a relu) are not products.  A train step
is three times its forward.  ``kernel_work``: each function the port's
kernels compute in a step — the ogb message summed at its receivers
(K1) and its backward (K2: the message's gradient per edge; the
senders' sum of it), the virtual node's broadcast to the nodes and its
backward, the pools and their backward — each input read once and each
output written once over the real rows, indices 4 bytes."""

F32, IDX = 4, 4


def _dims(flags):
    return (int(flags["--num_layers"]), int(flags["--d_out"]),
            int(flags["--d_h"]))


def rows(graphs):
    return (sum(g["x"].shape[0] for g in graphs),
            sum(g["edge_index"].shape[1] for g in graphs), len(graphs))


def model_flops(flags, dims, graphs, train: bool) -> float:
    L, d, h = _dims(flags)
    n, _e, g = rows(graphs)
    fwd = L * 2 * n * (d * h + h * d)               # update MLPs
    fwd += (L - 1) * 2 * g * (d * h + h * d)        # virtual-node MLPs
    fwd += 2 * g * d                                # prediction
    return 3 * fwd if train else fwd


def kernel_work(flags, graphs, batches: int, train: bool):
    """[(function, flops, bytes)] summed over ``batches`` steps on
    ``graphs``."""
    L, d, _h = _dims(flags)
    n, e, g = rows(graphs)
    rd, ed, gd = n * d * F32, e * d * F32, g * d * F32
    out = [("ogb_message", L * 3 * e * d,
            L * (rd + ed + e * IDX + n * IDX + rd)),
           ("vn_broadcast", 0, L * (gd + g * IDX + rd)),
           ("pools", L * n * d, L * (rd + g * IDX + gd))]
    if train:
        out += [("ogb_message_bwd", L * 2 * e * d,
                 L * (rd + rd + ed + e * IDX + n * IDX + ed)),
                ("sender_sum", L * e * d,
                 L * (ed + e * IDX + n * IDX + rd)),
                ("vn_broadcast_bwd", L * n * d, L * (rd + g * IDX + gd)),
                ("pools_bwd", 0, L * (gd + g * IDX + rd))]
    return out
