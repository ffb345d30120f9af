"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card; on a
machine with one (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small and ragged (empty segments, a width that is not a
multiple of 4 next to one that is) so both the float4 and the scalar
paths run; the DGN kernels also run at the DGN model's width (d=70)
with inputs drawn from a few integers, so maxima tie, and the molhiv
path's forms (K1/K2 with no A side, B4) at its width (d=300).
Tolerances:
forward rtol 2e-4 / atol 2e-5, gradients rtol 2e-3 / atol 1e-4 * max|g|;
tie counts are exact.
"""

import numpy as np
import pytest
import torch

from gsn_tpu_torch.ops.cuda import slab_combine as k3
from gsn_tpu_torch.ops.cuda import slab_message as k12
from gsn_tpu_torch.ops.cuda import slab_minmax as b6
from gsn_tpu_torch.ops.cuda import slab_pool as k4
from gsn_tpu_torch.ops.cuda import slab_weighted as b58

pytestmark = pytest.mark.cuda
FWD = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def ragged_segments(rng, n, e):
    """Receiver-sorted random edges over n nodes, with CSR views."""
    recv = np.sort(rng.randint(0, n, e))
    send = rng.randint(0, n, e).astype(np.int32)
    recv_ptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(recv, minlength=n), out=recv_ptr[1:])
    perm = np.argsort(send, kind="stable").astype(np.int32)
    send_ptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(send, minlength=n), out=send_ptr[1:])
    return [torch.from_numpy(a) for a in (recv_ptr, send, send_ptr, perm)]


def grad_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-3,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("d", [128, 30])
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("has_a,has_pe", [(True, True), (False, False)])
def test_edge_message_kernels(dev, d, act, has_a, has_pe):
    rng = np.random.RandomState(d)
    n, e, slots = 300, 900, 1000
    seg = k12.EdgeSegments(*(t.to(dev)
                             for t in ragged_segments(rng, n, e)))
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(n, d, device=dev, generator=gen) if has_a else None
    B = torch.randn(n, d, device=dev, generator=gen)
    Pe = (torch.randn(slots, d, device=dev, generator=gen) if has_pe
          else None)
    b1 = torch.randn(d, device=dev, generator=gen)
    g = torch.randn(n, d, device=dev, generator=gen)
    torch.testing.assert_close(
        k12.edge_message_fwd(A, B, Pe, b1, seg.recv_ptr, seg.send, act),
        k12.edge_message_fwd_plain(A, B, Pe, b1, seg.recv_ptr, seg.send,
                                   act), **FWD)
    got = k12.edge_message_bwd_recv(A, B, Pe, b1, g, seg.recv_ptr,
                                    seg.send, act, slots)
    want = k12.edge_message_bwd_recv_plain(A, B, Pe, b1, g, seg.recv_ptr,
                                           seg.send, act, slots)
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a, b, **FWD)

    leaves = [t.clone().requires_grad_(True) for t in (A, B, Pe, b1)
              if t is not None]
    ref_leaves = [t.clone().requires_grad_(True) for t in leaves]

    def unpack(ls):
        it = iter(ls)
        return [next(it) if t is not None else None
                for t in (A, B, Pe, b1)]

    out = k12.edge_message_aggregate(*unpack(leaves), seg, act)
    out_p = k12.edge_message_fwd_plain(*unpack(ref_leaves), seg.recv_ptr,
                                       seg.send, act)
    grad_close(torch.autograd.grad((out * g).sum(), leaves),
               torch.autograd.grad((out_p * g).sum(), ref_leaves))


@pytest.mark.parametrize("d", [128, 30])
def test_segment_kernels_and_pool(dev, d):
    rng = np.random.RandomState(7)
    recv_ptr, send, send_ptr, perm = (t.to(dev) for t in
                                      ragged_segments(rng, 200, 700))
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randn(700, d, device=dev, generator=gen)
    torch.testing.assert_close(
        k3.segment_sum_sorted(rows, send_ptr, perm),
        k3.segment_sum_sorted_plain(rows, send_ptr, perm), **FWD)
    torch.testing.assert_close(
        k3.segment_sum_sorted(rows, recv_ptr),
        k3.segment_sum_sorted_plain(rows, recv_ptr), **FWD)
    # graphs over the first 180 of 200 node rows; rows past them are
    # padding, and graph 3 is empty
    sizes = np.array([5, 40, 17, 0, 60, 58])
    graph_ptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)).to(dev)
    g = torch.randn(len(sizes), d, device=dev, generator=gen)
    torch.testing.assert_close(
        k4.segment_broadcast(g, graph_ptr, 200),
        k4.segment_broadcast_plain(g, graph_ptr, 200), **FWD)
    x = torch.randn(200, d, device=dev, generator=gen, requires_grad=True)
    x_p = x.detach().clone().requires_grad_(True)
    out = k4.add_pool(x, graph_ptr)
    out_p = k3.segment_sum_sorted_plain(x_p, graph_ptr)
    torch.testing.assert_close(out, out_p, **FWD)
    grad_close(torch.autograd.grad((out * g).sum(), [x]),
               torch.autograd.grad((out_p * g).sum(), [x_p]))


@pytest.mark.parametrize("d", [300, 30])
def test_edge_message_ogb_form(dev, d):
    """K1/K2 as the ogb message runs them: no A side, Pe given, relu, a
    constant zero b1 that takes no gradient; d=300 is the molhiv width
    (float4 path, three column passes of a warp, the third with 11
    lanes live)."""
    rng = np.random.RandomState(d + 1)
    n, e, slots = 300, 900, 1000
    seg = k12.EdgeSegments(*(t.to(dev)
                             for t in ragged_segments(rng, n, e)))
    gen = torch.Generator(device=dev).manual_seed(3)
    B = torch.randn(n, d, device=dev, generator=gen)
    Pe = torch.randn(slots, d, device=dev, generator=gen)
    b1 = torch.zeros(d, device=dev)
    g = torch.randn(n, d, device=dev, generator=gen)
    torch.testing.assert_close(
        k12.edge_message_fwd(None, B, Pe, b1, seg.recv_ptr, seg.send),
        k12.edge_message_fwd_plain(None, B, Pe, b1, seg.recv_ptr, seg.send),
        **FWD)
    dH, dA = k12.edge_message_bwd_recv(None, B, Pe, b1, g, seg.recv_ptr,
                                       seg.send, "relu", slots)
    dH_p, _ = k12.edge_message_bwd_recv_plain(None, B, Pe, b1, g,
                                              seg.recv_ptr, seg.send,
                                              "relu", slots)
    assert dA is None
    torch.testing.assert_close(dH, dH_p, **FWD)
    leaves = [x.clone().requires_grad_(True) for x in (B, Pe)]
    ref = [x.clone().requires_grad_(True) for x in (B, Pe)]
    out = k12.edge_message_aggregate(None, *leaves, b1, seg, "relu")
    out_p = k12.edge_message_fwd_plain(None, *ref, b1, seg.recv_ptr,
                                       seg.send)
    grad_close(torch.autograd.grad((out * g).sum(), leaves),
               torch.autograd.grad((out_p * g).sum(), ref))


@pytest.mark.parametrize("d", [300, 30])
def test_graph_broadcast(dev, d):
    """B4: K4 forward (exact copies, padding rows exactly 0) and K3
    backward against autograd through the plain version; one B4 count
    per call."""
    sizes = np.array([5, 40, 17, 0, 60, 58])
    graph_ptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(d)
    vn = torch.randn(len(sizes), d, device=dev, generator=gen)
    g = torch.randn(200, d, device=dev, generator=gen)
    before = k4.graph_broadcast.launches
    vl = vn.clone().requires_grad_(True)
    out = k4.graph_broadcast(vl, graph_ptr, 200)
    assert k4.graph_broadcast.launches == before + 1
    vp = vn.clone().requires_grad_(True)
    out_p = k4.graph_broadcast_plain(vp, graph_ptr, 200)
    assert torch.equal(out, out_p)
    assert not out[180:].any()
    grad_close(torch.autograd.grad((out * g).sum(), [vl]),
               torch.autograd.grad((out_p * g).sum(), [vp]))


def test_kernels_count_launches_and_reject_bf16(dev):
    before = k3.segment_sum_sorted.launches
    ptr = torch.tensor([0, 2, 3], dtype=torch.int32, device=dev)
    rows = torch.randn(3, 8, device=dev)
    k3.segment_sum_sorted(rows, ptr)
    assert k3.segment_sum_sorted.launches == before + 1
    with pytest.raises(TypeError, match="dtype"):
        k3.segment_sum_sorted(rows.bfloat16(), ptr)
    with pytest.raises(ValueError, match="activation"):
        k12.edge_message_fwd(rows, rows, None, rows[0], ptr,
                             ptr[:2].contiguous(), "id_sq")


def tied_rows(gen, n, d, dev):
    """Rows of small integers and zeros: many exact ties per column."""
    x = torch.randint(-3, 4, (n, d), device=dev, generator=gen).float()
    return torch.relu(x) * 0.5


@pytest.mark.parametrize("d", [70, 64])
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("op", ["weighted", "minmax", "fused"])
def test_dgn_kernels(dev, d, K, op):
    """K5/K6 in each instantiation against the plain versions: forward
    (tie counts exact), the raw backward with dW, and the autograd
    Function's dB and dW."""
    rng = np.random.RandomState(d + K)
    # 400 receivers over 1200 edges: rows without edges included
    seg = k12.EdgeSegments(*(t.to(dev)
                             for t in ragged_segments(rng, 400, 1200)))
    assert (seg.recv_ptr.diff() == 0).any()
    gen = torch.Generator(device=dev).manual_seed(K)
    B = tied_rows(gen, 400, d, dev)
    W = torch.rand(1200, K, device=dev, generator=gen)
    g_w = torch.randn(400, K * d, device=dev, generator=gen)
    g_mm = torch.randn(400, 2 * d, device=dev, generator=gen)
    rp, send = seg.recv_ptr, seg.send
    if op == "weighted":
        torch.testing.assert_close(
            b58.weighted_gather_fwd(B, W, rp, send),
            b58.weighted_gather_fwd_plain(B, W, rp, send), **FWD)
        got = b58.weighted_gather_bwd(B, W, g_w, rp, send, True)
        want = b58.weighted_gather_bwd_plain(B, W, g_w, rp, send, True)
        fn = lambda b, w: (b58.weighted_gather(b, w, seg),)  # noqa: E731
        plain = lambda b, w: b58.weighted_gather_bwd_plain(  # noqa: E731
            b, w, g_w, rp, send, True)
        cots = (g_w,)
    elif op == "minmax":
        mm, cnt = b6.segment_minmax_fwd(B, rp, send)
        mm_p, cnt_p = b6.segment_minmax_fwd_plain(B, rp, send)
        torch.testing.assert_close(mm, mm_p, **FWD)
        assert torch.equal(cnt, cnt_p)
        assert (cnt_p > 1).any()
        got = (b6.segment_minmax_bwd(B, mm, cnt, g_mm, rp, send),)
        want = (b6.minmax_dh_plain(B, mm_p, cnt_p, g_mm, rp, send),)
        fn = lambda b, w: (b6.segment_minmax(b, seg),)  # noqa: E731
        plain = lambda b, w: (b6.minmax_dh_plain(  # noqa: E731
            b, mm_p, cnt_p, g_mm, rp, send), None)
        cots = (g_mm,)
    else:
        out, mm, cnt = b58.dgn_fused_fwd(B, W, rp, send)
        out_p, mm_p, cnt_p = b58.dgn_fused_fwd_plain(B, W, rp, send)
        torch.testing.assert_close(out, out_p, **FWD)
        torch.testing.assert_close(mm, mm_p, **FWD)
        assert torch.equal(cnt, cnt_p)
        got = b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, rp, send, True)
        want = b58.dgn_fused_bwd_plain(B, W, g_w, mm_p, cnt_p, g_mm, rp,
                                       send, True)
        fn = lambda b, w: b58.dgn_fused(b, w, seg)  # noqa: E731
        plain = lambda b, w: b58.dgn_fused_bwd_plain(  # noqa: E731
            b, w, g_w, mm_p, cnt_p, g_mm, rp, send, True)
        cots = (g_w, g_mm)
    grad_close(got, want)

    Bl = B.clone().requires_grad_(True)
    Wl = W.clone().requires_grad_(op != "minmax")
    outs = fn(Bl, Wl)
    leaves = [Bl, Wl] if op != "minmax" else [Bl]
    grads = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cots)), leaves)
    dh_p, dW_p = plain(B, W)
    want = [k3.segment_sum_sorted_plain(dh_p, seg.send_ptr, seg.send_perm)]
    if op != "minmax":
        want.append(dW_p)
    grad_close(grads, want)


def test_dgn_kernels_count_launches_and_reject(dev):
    seg = k12.EdgeSegments(*(t.to(dev) for t in ragged_segments(
        np.random.RandomState(2), 50, 120)))
    B = torch.randn(50, 8, device=dev)
    W = torch.rand(120, 3, device=dev)
    rp, send = seg.recv_ptr, seg.send
    wrappers = (b58.weighted_gather_fwd, b58.weighted_gather_bwd,
                b6.segment_minmax_fwd, b6.segment_minmax_bwd,
                b58.dgn_fused_fwd, b58.dgn_fused_bwd)
    before = [w.launches for w in wrappers]
    out = b58.weighted_gather_fwd(B, W, rp, send)
    b58.weighted_gather_bwd(B, W, out, rp, send)
    mm, cnt = b6.segment_minmax_fwd(B, rp, send)
    b6.segment_minmax_bwd(B, mm, cnt, mm, rp, send)
    out, mm, cnt = b58.dgn_fused_fwd(B, W, rp, send)
    b58.dgn_fused_bwd(B, W, out, mm, cnt, mm, rp, send)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1] * 6
    with pytest.raises(ValueError, match="weight columns"):
        b58.weighted_gather_fwd(B, torch.rand(120, 17, device=dev), rp,
                                send)
    with pytest.raises(TypeError, match="dtype"):
        b6.segment_minmax_fwd(B.bfloat16(), rp, send)
