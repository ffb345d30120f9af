"""The port's edge-partitioned propagates
(``gsn_tpu_torch/parallel/edge_partition.py``) against the reference
package's, on the CPU.

Both partitions must give the reference's arrays bit for bit, and a CSR
layout consistent with them.  The propagates run in gloo ranks spawned
by ``parallel.launch`` (one launch per world size; D=3 tells the ring's
direction apart from its reverse) and are held to ``gsn_tpu``'s
``shard_map`` propagates on a D-device mesh of the host devices
``tests/conftest.py`` provides: forward rtol 1e-5 / atol 1e-5
(tests/test_edge_partition.py:45), the gradient of Σ out·cot w.r.t. x
at rtol 2e-3 / atol 1e-4·max|g| (tests/test_mxu_integration.py:79-84).
The module imports no JAX at its top, so the spawned ranks, which
import it to find their functions, never load JAX.
"""

import numpy as np
import pytest
import torch

from gsn_tpu_torch.parallel import edge_partition as ep
from gsn_tpu_torch.parallel import launch, make_mesh
from gsn_tpu_torch.parallel.mesh import Mesh

N, E, DIM = 48, 300, 16
FWD = dict(rtol=1e-5, atol=1e-5)
KINDS = {
    "allgather": (ep.partition_edges_by_receiver,
                  ep.edge_partitioned_propagate),
    "ring": (ep.partition_edges_ring, ep.ring_edge_partitioned_propagate),
}


def graph(seed=1):
    """(edge_index [2, E] with receivers in row 0, x [N, DIM], a
    cotangent [N, DIM])."""
    rng = np.random.RandomState(seed)
    ei = np.stack([rng.randint(0, N, E), rng.randint(0, N, E)])
    x = rng.randn(N, DIM).astype(np.float32)
    cot = rng.randn(N, DIM).astype(np.float32)
    return ei, x, cot


def message(xi, xj):
    return torch.tanh(xi) + 2.0 * xj


def assert_csr(recv, mask, order, recv_ptr, block):
    """Per rank: ``order`` lists the real slots sorted by receiver, ties
    in slot order, then the padding slots; ``recv_ptr`` offsets the
    receivers in that order."""
    for d in range(recv.shape[0]):
        n = int(mask[d].sum())
        real, pad = order[d, :n], order[d, n:]
        np.testing.assert_array_equal(np.sort(real), np.flatnonzero(mask[d]))
        np.testing.assert_array_equal(np.sort(pad), np.flatnonzero(~mask[d]))
        r = recv[d][real]
        assert all((a, i) < (b, j) for a, b, i, j in
                   zip(r[:-1], r[1:], real[:-1], real[1:]))
        assert recv_ptr[d].dtype == np.int32
        np.testing.assert_array_equal(
            np.repeat(np.arange(block), np.diff(recv_ptr[d])), r)


@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_partition_by_receiver_matches_reference(D):
    """The reference's arrays bit for bit, with and without an edge
    mask, and a consistent CSR layout."""
    from gsn_tpu.parallel.edge_partition import (
        partition_edges_by_receiver as ref_partition)
    ei, _x, _c = graph()
    for mask in (None, np.arange(E) % 7 != 3):
        got = ep.partition_edges_by_receiver(ei, N, D, mask)
        want = ref_partition(ei, N, D, mask)
        assert got["node_block"] == want["node_block"] == N // D
        for key in ("recv_local", "send_global", "edge_mask"):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert_csr(got["recv_local"], got["edge_mask"], got["order"],
                   got["recv_ptr"], N // D)
    with pytest.raises(ValueError, match="divisible"):
        ep.partition_edges_by_receiver(ei, N + 1, D if D > 1 else 2)


@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_partition_ring_matches_reference(D):
    """The reference's per-hop arrays (and per-hop slot counts) bit for
    bit, and each hop's CSR layout."""
    from gsn_tpu.parallel.edge_partition import (
        partition_edges_ring as ref_partition)
    ei, _x, _c = graph()
    got = ep.partition_edges_ring(ei, N, D)
    want = ref_partition(ei, N, D)
    assert got["node_block"] == want["node_block"]
    for key in ("recv_local", "send_local", "edge_mask"):
        assert len(got[key]) == len(want[key]) == D
        for k, (a, b) in enumerate(zip(got[key], want[key])):
            assert a.dtype == b.dtype and a.shape == b.shape, (key, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{key} hop {k}")
    for k in range(D):
        assert_csr(got["recv_local"][k], got["edge_mask"][k],
                   got["order"][k], got["recv_ptr"][k], N // D)


def _propagate_rank(rank, ei, x, cot, bench):
    mesh = make_mesh(axis_names=("ep",))
    out = {}
    for kind, (partition, propagate) in KINDS.items():
        parts = partition(ei, N, mesh.size)
        block = parts["node_block"]
        rows = slice(rank * block, (rank + 1) * block)
        prop = propagate(mesh, message)
        args = ep.rank_inputs(parts, rank, "cpu")
        xs = torch.from_numpy(x[rows].copy()).requires_grad_(True)
        y = prop(xs, *args)
        (g,) = torch.autograd.grad(
            (y * torch.from_numpy(cot[rows].copy())).sum(), [xs])
        out[kind] = dict(y=y.detach().numpy(), g=g.numpy())
    if bench:
        out["bench"] = ep.scaling_efficiency_bench(
            mesh, num_nodes=1024, avg_degree=4, d=32, iters=3)
    return out


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of one launch of D gloo ranks, by D (launched
    on first use)."""
    ei, x, cot = graph()
    launched = {}

    def get(D):
        if D not in launched:
            launched[D] = launch(_propagate_rank, D, "cpu",
                                 args=(ei, x, cot, D == 2))
        return launched[D]

    return get


def reference(kind, D):
    """gsn_tpu's propagate of ``kind`` on a D-device mesh: (out,
    d Σ out·cot / dx)."""
    import jax
    import jax.numpy as jnp
    from gsn_tpu.parallel import edge_partition as ref
    from gsn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    ei, x, cot = graph()
    mesh = jax_make_mesh(D, ("ep",))

    def msg(xi, xj):
        return jnp.tanh(xi) + 2.0 * xj

    if kind == "allgather":
        parts = ref.partition_edges_by_receiver(ei, N, D)
        prop = ref.edge_partitioned_propagate(mesh, msg)
        args = tuple(jnp.asarray(parts[k]) for k in
                     ("recv_local", "send_global", "edge_mask"))
    else:
        parts = ref.partition_edges_ring(ei, N, D)
        prop = ref.ring_edge_partitioned_propagate(mesh, msg)
        args = (parts["recv_local"], parts["send_local"],
                parts["edge_mask"])
    out = np.asarray(prop(jnp.asarray(x), *args))
    g = np.asarray(jax.grad(lambda v: jnp.sum(prop(v, *args) * cot))(
        jnp.asarray(x)))
    return out, g


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_propagate_matches_reference(ranks, kind, D):
    """Each rank's block of the output and of the gradient against the
    reference's."""
    results = ranks(D)
    want, want_g = reference(kind, D)
    block = N // D
    atol = 1e-4 * float(np.abs(want_g).max())
    for rank, res in enumerate(results):
        rows = slice(rank * block, (rank + 1) * block)
        got = res[kind]
        np.testing.assert_allclose(got["y"], want[rows], **FWD,
                                   err_msg=f"{kind} rank {rank}")
        np.testing.assert_allclose(got["g"], want_g[rows], rtol=2e-3,
                                   atol=atol, err_msg=f"{kind} rank {rank}")


def test_scaling_bench_runs(ranks):
    """``scaling_efficiency_bench`` over 2 ranks returns the reference's
    keys."""
    for res in ranks(2):
        out = res["bench"]
        assert set(out) == {"edges", "devices", "dist_edges_per_s",
                            "single_edges_per_s"}
        assert out["devices"] == 2 and out["edges"] == 1024 * 4
        assert out["dist_edges_per_s"] > 0 and out["single_edges_per_s"] > 0


def test_propagates_need_the_csr_layout():
    """A propagate sums only over the CSR layout: ``rank_inputs`` hands
    it (receivers, senders, order, recv_ptr), and a call without
    ``order`` and ``recv_ptr`` is refused before any collective (there
    is no process group here)."""
    mesh = Mesh(axis="ep", size=1, rank=0, device=torch.device("cpu"))
    ei, x, _c = graph()
    for kind, (partition, propagate) in KINDS.items():
        args = ep.rank_inputs(partition(ei, N, 1), 0, "cpu")
        assert len(args) == 4, kind
        with pytest.raises(TypeError):
            propagate(mesh, message)(torch.from_numpy(x), *args[:2])
