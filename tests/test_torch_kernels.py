"""The port's kernel modules (``gsn_tpu_torch/ops/cuda``) against the
reference package's Pallas kernels, on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors;
the reference runs its kernels as its own tests do here (Pallas
interpret mode / the chunk-by-chunk emulation of the same kernel body).
Tolerances are the reference's kernel-vs-plain ones
(tests/test_mxu_integration.py:48,79-84): forward rtol 2e-4 / atol 2e-5,
gradients rtol 2e-3 / atol 1e-4 * max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsn_tpu.ops.pallas.slab_combine import combine_kc, slab_combine_sum
from gsn_tpu.ops.pallas.slab_message import slab_edge_message_aggregate
from gsn_tpu.ops.pallas.slab_pool import build_pool_metadata, slab_add_pool
from gsn_tpu_torch.ops.cuda import slab_combine as k3
from gsn_tpu_torch.ops.cuda import slab_message as k12
from gsn_tpu_torch.ops.cuda import slab_pool as k4

from test_slab_message import BE, BN
from test_slab_message import setup as slab_setup
from test_slab_pool import _synthetic_batch

FWD = dict(rtol=2e-4, atol=2e-5)


def assert_grad_close(got, want, err_msg=""):
    atol = 1e-4 * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=atol,
                               err_msg=err_msg)


def csr(keys, num_segments):
    ptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=num_segments), out=ptr[1:])
    return torch.from_numpy(ptr.astype(np.int32))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("with_pe,e_pad", [(True, 0), (False, 37),
                                           (True, 300)])
def test_edge_message_matches_slab_kernel(act, with_pe, e_pad):
    """K1/K2's plain versions through EdgeMessageAggregate: forward and
    dA, dB, dPe, db1 against slab_edge_message_aggregate."""
    s = slab_setup(with_pe=with_pe, e_pad=e_pad)
    N, E = s["N"], s["E"]
    g_out = np.random.RandomState(7).randn(
        s["num_nodes"], s["A"].shape[1]).astype(np.float32)

    def ref(A, B, Pe, b1):
        return slab_edge_message_aggregate(
            A, B, Pe, b1, jnp.asarray(s["meta"]["recv_local"]),
            jnp.asarray(s["meta"]["send_local"]), jnp.asarray(s["fb_wf"]),
            N, s["num_nodes"], BN, BE, act, with_pe, True, None, "float32",
            True, s["meta"]["s_s"])

    pe_j = jnp.asarray(s["Pe"]) if with_pe else jnp.zeros((1, 1))
    args = (jnp.asarray(s["A"]), jnp.asarray(s["B"]), pe_j,
            jnp.asarray(s["b1"]))
    out_ref = np.asarray(ref(*args))
    argnums = (0, 1, 2, 3) if with_pe else (0, 1, 3)
    g_ref = jax.grad(lambda *a: jnp.sum(ref(*a) * g_out),
                     argnums=argnums)(*args)

    send = s["send"].astype(np.int32)
    seg = k12.EdgeSegments(csr(s["recv"], N), t(send), csr(send, N),
                           t(np.argsort(send, kind="stable")
                             .astype(np.int32)))
    leaves = [t(s["A"]), t(s["B"]), t(s["Pe"]) if with_pe else None,
              t(s["b1"])]
    for x in leaves:
        if x is not None:
            x.requires_grad_(True)
    out = k12.edge_message_aggregate(*leaves, seg, act)
    np.testing.assert_allclose(out.detach().numpy(), out_ref[:N], **FWD)
    (out * t(g_out[:N])).sum().backward()

    got = [leaves[0].grad, leaves[1].grad] + (
        [leaves[2].grad] if with_pe else []) + [leaves[3].grad]
    names = ["dA", "dB"] + (["dPe"] if with_pe else []) + ["db1"]
    for name, a, b in zip(names, got, g_ref):
        assert_grad_close(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("sorted_key", [True, False])
@pytest.mark.parametrize("gathered", [False, True])
def test_segment_sum_matches_slab_combine(sorted_key, gathered):
    """K3's plain version, written as a sorted segment sum over the slab
    rows, against slab_combine_sum; through ``perm`` or over rows already
    gathered into segment order."""
    rng = np.random.RandomState(0 if sorted_key else 1)
    C, span, block_n, d, num_blocks = 17, 3, 8, 10, 9
    key = rng.randint(0, num_blocks - span + 1, C).astype(np.int32)
    if sorted_key:
        key = np.sort(key)
    slabs = rng.randn(C, span * block_n, d).astype(np.float32)
    kc = combine_kc(key, span, num_blocks)
    want = np.asarray(slab_combine_sum(
        jnp.asarray(slabs), jnp.asarray(key), span, num_blocks, block_n, d,
        kc, interpret=True))

    # slab row (t, j, i) lands on output row (key[t] + j) * block_n + i
    tt, jj, ii = np.meshgrid(np.arange(C), np.arange(span),
                             np.arange(block_n), indexing="ij")
    out_row = ((key[tt] + jj) * block_n + ii).reshape(-1)
    rows = slabs.reshape(-1, d)
    perm = np.argsort(out_row, kind="stable").astype(np.int32)
    ptr = csr(out_row, num_blocks * block_n)
    if gathered:
        got = k3.segment_sum_sorted(t(rows[perm]), ptr)
    else:
        got = k3.segment_sum_sorted(t(rows), ptr, t(perm))
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("graph_cap", [256, 512])
def test_add_pool_matches_slab_add_pool(graph_cap):
    """K3 (forward) and K4 (backward) plain versions through AddPool
    against slab_add_pool, padding rows included."""
    rng = np.random.RandomState(1)
    batch_p, mask, n, node_cap, sizes = _synthetic_batch(rng, 250)
    meta = build_pool_metadata(batch_p, mask, graph_cap)
    assert meta is not None
    x = rng.randn(node_cap, 32).astype(np.float32)
    w = rng.randn(graph_cap, 32).astype(np.float32)
    n_pad = meta["recv_local"].shape[0]

    def ref(xp):
        return slab_add_pool(xp, jnp.asarray(meta["recv_local"]),
                             jnp.asarray(meta["fb"]), graph_cap,
                             meta["block_g"], meta["block_e"], True)

    xp = jnp.asarray(np.pad(x, ((0, n_pad - node_cap), (0, 0))))
    out_ref = np.asarray(ref(xp))
    g_ref = np.asarray(jax.grad(
        lambda a: jnp.sum(jnp.tanh(ref(a)) * w))(xp))[:node_cap]

    graph_ptr = csr(batch_p[mask], graph_cap)
    xt = t(x).requires_grad_(True)
    out = k4.add_pool(xt, graph_ptr)
    np.testing.assert_allclose(out.detach().numpy(), out_ref, **FWD)
    (torch.tanh(out) * t(w)).sum().backward()
    assert_grad_close(xt.grad.numpy(), g_ref)
    assert not xt.grad.numpy()[~mask].any()


@pytest.mark.parametrize("lead,trail", [(0, 29), (13, 0), (7, 40)])
@pytest.mark.parametrize("d", [1, 3, 70])
def test_segment_broadcast_matches_slab_pool_vjp(lead, trail, d):
    """K4's plain version, alone and as AddPool's backward, against the
    VJP of slab_add_pool (interpret mode) on a ragged batch: every fifth
    graph empty, ``lead`` padding rows before the first graph and
    ``trail`` after the last; the one-hot product copies rows, so the
    two agree exactly."""
    rng = np.random.RandomState(lead + d)
    sizes = rng.randint(3, 13, 40)
    sizes[::5] = 0
    G, n_rows = len(sizes), lead + int(sizes.sum()) + trail
    batch = np.zeros(n_rows, np.int32)
    mask = np.zeros(n_rows, bool)
    batch[lead:n_rows - trail] = np.repeat(np.arange(G), sizes)
    mask[lead:n_rows - trail] = True
    meta = build_pool_metadata(batch, mask, G, block_g=16, block_e=32)
    assert meta is not None
    n_pad = meta["recv_local"].shape[0]
    g = rng.randn(G, d).astype(np.float32)

    def ref(xp):
        return slab_add_pool(xp, jnp.asarray(meta["recv_local"]),
                             jnp.asarray(meta["fb"]), G, meta["block_g"],
                             meta["block_e"], True)

    _, vjp = jax.vjp(ref, jnp.zeros((n_pad, d), jnp.float32))
    want = np.asarray(vjp(jnp.asarray(g))[0])[:n_rows]

    ptr = torch.from_numpy(
        (lead + np.r_[0, np.cumsum(sizes)]).astype(np.int32))
    np.testing.assert_array_equal(
        k4.segment_broadcast(t(g), ptr, n_rows).numpy(), want)
    x = torch.zeros(n_rows, d, requires_grad=True)
    k4.add_pool(x, ptr).backward(t(g))
    np.testing.assert_array_equal(x.grad.numpy(), want)
    assert not want[~mask].any()


def test_segment_broadcast_plain_zero_outside_segments():
    """K4 fills rows before the first and after the last segment with 0
    and skips empty segments."""
    g = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ptr = torch.tensor([2, 4, 4, 5, 7], dtype=torch.int32)
    out = k4.segment_broadcast(g, ptr, 9)
    want = torch.zeros(9, 3)
    want[2:4] = g[0]
    want[4] = g[2]
    want[5:7] = g[3]
    torch.testing.assert_close(out, want)


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    """On CPU tensors the wrappers run the plain versions; the launch
    counters move only where a kernel launches."""
    wrappers = (k12.edge_message_fwd, k12.edge_message_bwd_recv,
                k3.segment_sum_sorted, k4.segment_broadcast)
    before = [w.launches for w in wrappers]
    A = torch.randn(3, 4)
    ptr = torch.tensor([0, 1, 3, 3], dtype=torch.int32)
    send = torch.tensor([2, 0, 1], dtype=torch.int32)
    out = k12.edge_message_fwd(A, A, None, torch.zeros(4), ptr, send)
    torch.testing.assert_close(out, k12.edge_message_fwd_plain(
        A, A, None, torch.zeros(4), ptr, send))
    k12.edge_message_bwd_recv(A, A, None, torch.zeros(4), A, ptr, send)
    k3.segment_sum_sorted(A, ptr)
    k4.segment_broadcast(A, ptr, 3)
    assert [w.launches for w in wrappers] == before


def test_wrappers_reject_other_devices_and_activations():
    A = torch.randn(3, 4, device="meta")
    ptr = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k3.segment_sum_sorted(A, ptr)
    with pytest.raises(ValueError, match="no kernel"):
        k4.segment_broadcast(A, ptr, 3)
    with pytest.raises(ValueError, match="activation"):
        k12.edge_message_fwd_plain(
            torch.zeros(1, 2), torch.zeros(1, 2), None, torch.zeros(2),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(0, dtype=torch.int32), "elu")
