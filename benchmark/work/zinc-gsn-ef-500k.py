"""Work of GSN-EF on ZINC as functions of a set's real rows: N nodes,
E directed edges, G graphs, b batches; d the width, L the layers, f32.

``model_flops``: the matrix products of the model's forward (a dense
layer of k inputs and n outputs on m rows is 2·m·k·n), the first
message layer at node level (each part projected once per node, as the
linear map of a concatenation allows), the one-hot bonds on edges; a
train step is three times its forward (the inputs' and the weights'
gradients).  ``kernel_work``: each function the port's kernels compute
in a step (the messages' sums over receivers and the pool; in training
their backward, a broadcast), each input read once and each output
written once over the real rows, indices 4 bytes."""

ATOMS, BONDS, F32, IDX = 28, 4, 4, 4


def _dims(flags):
    return int(flags["--num_layers"]), int(flags["--d_out"])


def rows(graphs):
    return (sum(g["x"].shape[0] for g in graphs),
            sum(g["edge_index"].shape[1] for g in graphs), len(graphs))


def model_flops(flags, dims, graphs, train: bool) -> float:
    L, d = _dims(flags)
    n, e, g = rows(graphs)
    d_id = sum(dims)
    fwd = 0.0
    d_x = ATOMS
    for i in range(L):
        node_in = d_x + (d_id if i == 0 else 0)
        fwd += 2 * 2 * n * node_in * d + 2 * e * BONDS * d   # first layer
        fwd += 2 * e * d * d                                # dense_1
        fwd += 2 * n * (d_x + d) * d + 2 * n * d * d        # update MLP
        d_x = d
    fwd += 2 * g * d * d + 2 * g * d                        # jk_mlp head
    return 3 * fwd if train else fwd


def kernel_work(flags, graphs, batches: int, train: bool):
    """[(function, flops, bytes)] summed over ``batches`` steps on
    ``graphs``."""
    L, d = _dims(flags)
    n, e, g = rows(graphs)
    out = [("receiver_sum", L * e * d,
            L * (e * d * F32 + n * IDX + n * d * F32)),
           ("pool", n * d, n * d * F32 + g * IDX + g * d * F32)]
    if train:
        out += [("receiver_sum_bwd", 0, L * (n * d * F32 + n * IDX
                                             + e * d * F32)),
                ("pool_bwd", 0, g * d * F32 + g * IDX + n * d * F32)]
    return out
