"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card; on a
machine with one (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small and ragged (empty segments, a hub row of more than 32
edges, a width that is not a multiple of 4 next to one that is) so both
the float4 and the scalar paths run; the DGN kernels run at widths that
take each of their column layouts (d=33, 64, the DGN model's 70, and
130, which spans two column tiles) with K of 1, 5 and 16 weight
columns and inputs drawn from a few integers, so maxima tie, and the
molhiv path's forms (K1/K2 with no A side, B4) at its width (d=300),
and the gin message's (identity, no A side, a node part or an edge part
with a zero B) at d=1, 3, 64 and the odd id width 689;
K4 runs on its stress layouts (empty graphs, leading and trailing
padding, one graph, none) at widths 1 to 300 with aligned and unaligned
g.  Tolerances:
forward rtol 2e-4 / atol 2e-5, gradients rtol 2e-3 / atol 1e-4 * max|g|;
tie counts are exact, and so is K4, which copies rows.

K1–K4 also run in bf16 at the paths' widths (128, 300) and at odd ones
(33, and 1 to 300 for K4), against their plain versions: K4 and dH bit
for bit (copies and masked copies of bf16 values); K1, dA, dB and every
sum rounded to bf16 at rtol 8e-3 / atol 1e-4 * max|want| (one bf16 ulp:
the plain versions sum in another order, and a rounding may fall on the
other side); K3 into f32 at the f32 tolerances.  K5/K6 run on bf16 rows
at the same DGN shapes: the f32 outputs (weighted sums, dW) at the f32
tolerances, maxima and tie counts exact, dh and dB within one bf16 ulp.
K1/K2's fused-BN moments mode (``id_sq``) runs on f32 and bf16 data:
its f32 moments and dH at the f32 tolerances, dA, dB and dPe in the
data dtype (one bf16 ulp in bf16); K3 from f32 rows into bf16 within
one bf16 ulp.

K1, K2 and K3 also run at widths 2 to 298 (pairs, odd widths, the
published ZINC width 150, two column tiles) over segments of 0 to 2,000
rows, K3 in both of its forms; sums of the same terms in another order
are held to one bf16 ulp, or in f32 to the tolerances above plus the
worst-case rounding of two f32 sums of the row's terms, 2 (n - 1) 2^-24
sum |x| (the long rows cancel).  K2's relu and identity dH are masked
copies of g, bit for bit.  K3's block form and K2 must give the same
bits on every call.

The edge-partitioned propagates (``parallel/edge_partition.py``) run
over an NCCL group of one against their plain CPU version at the f32
tolerances, one K3 and one K4 launch each.

The one-dispatch epochs (``TrainerConfig.scan_epochs``): a small zinc
model's graphed train and eval steps against its per-step ones bit for
bit (losses, evaluations, parameters, BN statistics, launches), a
Plateau rate change reaching the replayed Adam, and a step that reads
the device from the host raising at its capture.  ``ParallelTrainer``'s
graphed dp and ep epochs on an NCCL group of one (the collectives
captured with the step) against its per-step ones, bit for bit.
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
    """Receiver-sorted random edges over n nodes, with CSR views; a third
    of them (at most 100) go to one hub receiver."""
    recv = rng.randint(0, n, e)
    recv[:min(100, e // 3)] = n // 2
    recv = np.sort(recv)
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


def bf16_close(got, want):
    """One bf16 ulp, in the working type (see module docstring)."""
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=1e-4 * float(want.float().abs().max()))


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
    assert torch.equal(k4.segment_broadcast(g, graph_ptr, 200),
                       k4.segment_broadcast_plain(g, graph_ptr, 200))
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


@pytest.mark.parametrize("d", [1, 3, 689, 64])
@pytest.mark.parametrize("part", ["node", "edge"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_message_gin_form(dev, d, part, dtype):
    """K1/K2 as the gin message runs them: identity, no A side, a zero
    b1; a node part (B = x, no Pe) or an edge part (a zero B, Pe the
    edge rows).  d=1 is the IMDB model's layer-0 input, 689 an odd id
    width (its one-hot ids, extended by the central column), 3 odd and
    64 the published width.  Sums at the f32 tolerances or one bf16 ulp;
    dH (a copy of g) bit for bit."""
    rng = np.random.RandomState(d + (part == "edge"))
    n, e, slots = 300, 900, 1000
    seg = k12.EdgeSegments(*(t.to(dev)
                             for t in ragged_segments(rng, n, e)))
    gen = torch.Generator(device=dev).manual_seed(5)
    if part == "node":
        B = torch.randn(n, d, device=dev, generator=gen).to(dtype)
        Pe = None
    else:
        B = torch.zeros(n, d, device=dev, dtype=dtype)
        Pe = torch.randn(slots, d, device=dev, generator=gen).to(dtype)
    b1 = torch.zeros(d, device=dev)
    g = torch.randn(n, d, device=dev, generator=gen).to(dtype)
    close = (bf16_close if dtype == torch.bfloat16
             else lambda a, b: torch.testing.assert_close(a, b, **FWD))
    close(k12.edge_message_fwd(None, B, Pe, b1, seg.recv_ptr, seg.send,
                               "identity"),
          k12.edge_message_fwd_plain(None, B, Pe, b1, seg.recv_ptr, seg.send,
                                     "identity"))
    dH, dA = k12.edge_message_bwd_recv(None, B, Pe, b1, g, seg.recv_ptr,
                                       seg.send, "identity", slots)
    dH_p, _ = k12.edge_message_bwd_recv_plain(None, B, Pe, b1, g,
                                              seg.recv_ptr, seg.send,
                                              "identity", slots)
    assert dA is None
    assert torch.equal(dH, dH_p)
    leaf = (B if part == "node" else Pe).clone().requires_grad_(True)
    args = (None, leaf, None) if part == "node" else (None, B, leaf)
    out = k12.edge_message_aggregate(*args, b1, seg, "identity")
    got = torch.autograd.grad((out.float() * g.float()).sum(), [leaf])[0]
    # dB: K3 over the senders, an f32 sum rounded once; dPe: dH
    want = (k3.segment_sum_sorted_plain(dH_p, seg.send_ptr, seg.send_perm,
                                        dtype)
            if part == "node" else dH_p)
    if dtype == torch.bfloat16:
        bf16_close(got, want)
    else:
        grad_close([got], [want])


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


@pytest.mark.parametrize("d", [128, 300, 33])
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("has_a,has_pe", [(True, True), (False, True),
                                          (False, False)])
def test_edge_message_kernels_bf16(dev, d, act, has_a, has_pe):
    """K1/K2 on bf16 data (f32 b1) at the zinc width (8-element loads),
    the molhiv width (4-element loads: a 600-byte row is 8-byte aligned)
    and an odd one, against the plain versions; the autograd Function's
    gradients against the plain backward (dA, dB, dPe in bf16, db1 f32)."""
    rng = np.random.RandomState(d + 2)
    n, e, slots = 300, 900, 1000
    seg = k12.EdgeSegments(*(t.to(dev)
                             for t in ragged_segments(rng, n, e)))
    gen = torch.Generator(device=dev).manual_seed(d)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    A = rnd(n, d) if has_a else None
    B = rnd(n, d)
    Pe = rnd(slots, d) if has_pe else None
    b1 = torch.randn(d, device=dev, generator=gen)
    g = rnd(n, d)
    rp, send = seg.recv_ptr, seg.send
    out = k12.edge_message_fwd(A, B, Pe, b1, rp, send, act)
    bf16_close(out, k12.edge_message_fwd_plain(A, B, Pe, b1, rp, send, act))
    dH, dA = k12.edge_message_bwd_recv(A, B, Pe, b1, g, rp, send, act,
                                       slots)
    dH_p, dA_p = k12.edge_message_bwd_recv_plain(A, B, Pe, b1, g, rp, send,
                                                 act, slots)
    assert torch.equal(dH, dH_p)
    if has_a:
        bf16_close(dA, dA_p)
    leaves = [t.clone().requires_grad_(True) for t in (A, B, Pe, b1)
              if t is not None]
    it = iter(leaves)
    args = [next(it) if t is not None else None for t in (A, B, Pe, b1)]
    got = torch.autograd.grad(
        (k12.edge_message_aggregate(*args, seg, act).float() * g.float())
        .sum(), leaves)
    want = ([dA_p] if has_a else []) + [k3.segment_sum_sorted_plain(
        dH_p, seg.send_ptr, seg.send_perm, torch.bfloat16)] + (
            [dH_p] if has_pe else [])
    for a, b in zip(got[:-1], want):
        bf16_close(a, b)
    assert got[-1].dtype == torch.float32
    torch.testing.assert_close(got[-1], dH_p.float().sum(0), rtol=2e-3,
                               atol=1e-4 * float(dH_p.float().abs().max()))


@pytest.mark.parametrize("d", [128, 300, 33])
def test_segment_sum_kernel_bf16(dev, d):
    """K3 on bf16 rows, into f32 (the pools) and into bf16 (dB, B4's
    backward), through a permutation and without."""
    rng = np.random.RandomState(d + 3)
    recv_ptr, send, send_ptr, perm = (t.to(dev) for t in
                                      ragged_segments(rng, 200, 700))
    rows = torch.randn(700, d, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(d)
                       ).bfloat16()
    for ptr, p in ((send_ptr, perm), (recv_ptr, None)):
        torch.testing.assert_close(
            k3.segment_sum_sorted(rows, ptr, p),
            k3.segment_sum_sorted_plain(rows, ptr, p), **FWD)
        bf16_close(k3.segment_sum_sorted(rows, ptr, p, torch.bfloat16),
                   k3.segment_sum_sorted_plain(rows, ptr, p, torch.bfloat16))


def k4_layout(name):
    """(graph_ptr [G+1] int32, rows) of a K4 stress layout."""
    sizes = np.random.RandomState(5).randint(1, 40, 300)
    sizes[::7] = 0
    off = np.cumsum(sizes)
    ptr, n_rows = {
        "empty graphs, trailing padding": (np.r_[0, off], off[-1] + 37),
        "leading padding": (np.r_[13, 13 + off], off[-1] + 13),
        "one graph": (np.array([3, 900]), 950),
        "no graphs": (np.array([5]), 40),
    }[name]
    return torch.from_numpy(ptr.astype(np.int32)), int(n_rows)


def k4_stress_case(dev, layout, d, aligned, dtype):
    """K4 on a stress layout: K4, AddPool's backward (K4 of the cotangent
    rounded to x's dtype) and GraphBroadcast (K4 forward, K3 backward)
    against their plain versions, the copies bit for bit."""
    ptr, n_rows = k4_layout(layout)
    ptr = ptr.to(dev)
    G = ptr.numel() - 1
    gen = torch.Generator(device=dev).manual_seed(d)
    base = torch.randn(G * d + 1, device=dev, generator=gen).to(dtype)
    x = torch.randn(n_rows, d, device=dev, generator=gen).to(dtype)
    sl = slice(0, G * d) if aligned else slice(1, G * d + 1)
    g = base[sl].view(G, d)
    want = k4.segment_broadcast_plain(g, ptr, n_rows)
    before = k4.segment_broadcast.launches
    assert torch.equal(k4.segment_broadcast(g, ptr, n_rows), want)
    assert k4.segment_broadcast.launches == before + 1
    if G == 0:  # every row is 0; there is nothing to pool or broadcast
        return
    assert (g.data_ptr() % 16 == 0) == aligned
    xl = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(k4.add_pool(xl, ptr), [xl],
                                grad_outputs=g.float())
    assert torch.equal(dx, want)
    bl = base.clone().requires_grad_(True)
    out = k4.graph_broadcast(bl[sl].view(G, d), ptr, n_rows)
    assert torch.equal(out, k4.graph_broadcast_plain(g, ptr, n_rows))
    (dv,) = torch.autograd.grad((out.float() * x.float()).sum(), [bl])
    want_dv = k3.segment_sum_sorted_plain(x, ptr, out_dtype=dtype)
    if dtype == torch.bfloat16:
        bf16_close(dv[sl].view(G, d), want_dv)
    else:
        grad_close([dv[sl].view(G, d)], [want_dv])


@pytest.mark.parametrize("layout", ["empty graphs, trailing padding",
                                    "leading padding", "one graph",
                                    "no graphs"])
@pytest.mark.parametrize("d", [1, 3, 33, 70, 128, 130, 300])
@pytest.mark.parametrize("aligned", [True, False])
def test_segment_broadcast_stress(dev, layout, d, aligned):
    """K4 equals its plain version bit for bit on empty graphs, leading
    and trailing padding, one graph and none, at widths below, at and
    past a float4 and at the paths' 70, 128 and 300, with g aligned or a
    view one float off 16-byte alignment; through K4, AddPool's backward
    (K4 of the cotangent as given) and GraphBroadcast (K4 forward, K3
    backward)."""
    k4_stress_case(dev, layout, d, aligned, torch.float32)


@pytest.mark.parametrize("layout", ["empty graphs, trailing padding",
                                    "leading padding", "one graph",
                                    "no graphs"])
@pytest.mark.parametrize("d", [1, 3, 33, 70, 128, 130, 300])
@pytest.mark.parametrize("aligned", [True, False])
def test_segment_broadcast_stress_bf16(dev, layout, d, aligned):
    """The same on bf16 rows (16-byte vectors of 8 elements; loads of 8,
    4, 2 or 1 by width and alignment; the unaligned view one element
    off)."""
    k4_stress_case(dev, layout, d, aligned, torch.bfloat16)


def test_kernels_count_launches_and_reject_bf16(dev):
    """Launches count in all and by mode; bf16 is taken (K1–K4 take f32
    or bf16), other dtypes and mixed data dtypes are refused, and so is
    an activation the kernels lack."""
    before = k3.segment_sum_sorted.launches
    modes = dict(k3.segment_sum_sorted.modes)
    ptr = torch.tensor([0, 2, 3], dtype=torch.int32, device=dev)
    rows = torch.randn(3, 8, device=dev)
    k3.segment_sum_sorted(rows, ptr)
    k3.segment_sum_sorted(rows.bfloat16(), ptr)
    k3.segment_sum_sorted(rows.bfloat16(), ptr, out_dtype=torch.bfloat16)
    assert k3.segment_sum_sorted.launches == before + 3
    for mode in ("f32->f32", "bf16->f32", "bf16->bf16"):
        assert k3.segment_sum_sorted.modes[mode] == modes.get(mode, 0) + 1
    # f32 rows into bf16 (dB of the fused-BN moments pass)
    k3.segment_sum_sorted(rows, ptr, out_dtype=torch.bfloat16)
    assert k3.segment_sum_sorted.modes["f32->bf16"] == modes.get(
        "f32->bf16", 0) + 1
    with pytest.raises(TypeError, match="dtype"):
        k3.segment_sum_sorted(rows.half(), ptr)
    with pytest.raises(TypeError, match="dtype"):
        k3.segment_sum_sorted(rows, ptr, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        k12.edge_message_fwd(rows, rows.bfloat16(), None, rows[0], ptr,
                             ptr[:2].contiguous())
    # the id_sq moments pass counts by data dtype; its cotangent is f32
    fwd_modes = dict(k12.edge_message_fwd.modes)
    send = ptr[:2].contiguous()   # two receivers, senders among 3 rows
    for x in (rows, rows.bfloat16()):
        hs = k12.edge_message_fwd(x[:2], x, None, rows[0], ptr, send,
                                  "id_sq")
        assert hs.dtype == torch.float32 and hs.shape == (2, 16)
        k12.edge_message_bwd_recv(x[:2], x, None, rows[0], hs, ptr, send,
                                  "id_sq")
    for mode in ("f32 id_sq", "bf16 id_sq"):
        assert k12.edge_message_fwd.modes[mode] == fwd_modes.get(mode, 0) + 1
    with pytest.raises(TypeError, match="dtype"):
        k12.edge_message_bwd_recv(rows[:2], rows, None, rows[0],
                                  hs.bfloat16(), ptr, send, "id_sq")
    with pytest.raises(ValueError, match="shape"):
        k12.edge_message_bwd_recv(rows[:2], rows, None, rows[0], rows[:2],
                                  ptr, send, "id_sq")
    with pytest.raises(ValueError, match="activation"):
        k12.edge_message_fwd(rows, rows, None, rows[0], ptr, send, "elu")


def tied_rows(gen, n, d, dev):
    """Rows of small integers and zeros: many exact ties per column."""
    x = torch.randint(-3, 4, (n, d), device=dev, generator=gen).float()
    return torch.relu(x) * 0.5


@pytest.mark.parametrize("d", [70, 64, 33, 130])
@pytest.mark.parametrize("K", [1, 5, 16])
@pytest.mark.parametrize("op", ["weighted", "minmax", "fused"])
def test_dgn_kernels(dev, d, K, op):
    """K5/K6 in each instantiation against the plain versions: forward
    (tie counts exact), the raw backward with dW, and the autograd
    Function's dB and dW."""
    rng = np.random.RandomState(d + K)
    # 400 receivers over 1200 edges: rows without edges included, and a
    # hub row whose edges take several 32-edge chunks
    seg = k12.EdgeSegments(*(t.to(dev)
                             for t in ragged_segments(rng, 400, 1200)))
    assert (seg.recv_ptr.diff() == 0).any()
    assert int(seg.recv_ptr.diff().max()) >= 100
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
    # bf16 rows count as their own mode; W, mm, cnt and g_mm stay f32
    Bb = B.bfloat16()
    modes = [dict(w.modes) for w in wrappers]
    out = b58.weighted_gather_fwd(Bb, W, rp, send)
    b58.weighted_gather_bwd(Bb, W, out, rp, send)
    mm, cnt = b6.segment_minmax_fwd(Bb, rp, send)
    b6.segment_minmax_bwd(Bb, mm, cnt, mm, rp, send)
    out, mm, cnt = b58.dgn_fused_fwd(Bb, W, rp, send)
    b58.dgn_fused_bwd(Bb, W, out, mm, cnt, mm, rp, send)
    torch.cuda.synchronize()
    assert [w.modes.get("bf16", 0) - m.get("bf16", 0)
            for w, m in zip(wrappers, modes)] == [1] * 6
    with pytest.raises(TypeError, match="dtype"):
        b6.segment_minmax_fwd(B.half(), rp, send)
    with pytest.raises(TypeError, match="dtype"):
        b58.weighted_gather_fwd(Bb, W.bfloat16(), rp, send)
    with pytest.raises(TypeError, match="dtype"):
        b6.segment_minmax_bwd(Bb, mm.bfloat16(), cnt, mm, rp, send)


@pytest.mark.parametrize("d", [70, 64, 33, 130])
@pytest.mark.parametrize("K", [1, 5, 16])
@pytest.mark.parametrize("op", ["weighted", "minmax", "fused"])
def test_dgn_kernels_bf16(dev, d, K, op):
    """K5/K6 on bf16 rows (f32 W, g_mm) against the plain versions: the
    f32 weighted sums and dW at the f32 tolerances, maxima and tie counts
    exact, dh within one bf16 ulp, and the autograd Function's dB (bf16)
    within one ulp of K3's plain sum of the kernel's dh (a dh one ulp off
    may move a sum of several by more); d=130 spans two tiles."""
    rng = np.random.RandomState(d + K + 1)
    seg = k12.EdgeSegments(*(t.to(dev)
                             for t in ragged_segments(rng, 400, 1200)))
    gen = torch.Generator(device=dev).manual_seed(K + 1)
    B = tied_rows(gen, 400, d, dev).bfloat16()
    W = torch.rand(1200, K, device=dev, generator=gen)
    g_w = torch.randn(400, K * d, device=dev, generator=gen)
    g_mm = torch.randn(400, 2 * d, device=dev, generator=gen)
    rp, send = seg.recv_ptr, seg.send
    weighted, minmax = op != "minmax", op != "weighted"
    if minmax:
        mm, cnt = b6.segment_minmax_fwd(B, rp, send)
        mm_p, cnt_p = b6.segment_minmax_fwd_plain(B, rp, send)
        assert torch.equal(mm, mm_p) and torch.equal(cnt, cnt_p)
        assert (cnt_p > 1).any()
    if op == "weighted":
        out = b58.weighted_gather_fwd(B, W, rp, send)
        got = b58.weighted_gather_bwd(B, W, g_w, rp, send, True)
        want = b58.weighted_gather_bwd_plain(B, W, g_w, rp, send, True)
        fn = lambda b, w: (b58.weighted_gather(b, w, seg),)  # noqa: E731
        cots = (g_w,)
    elif op == "minmax":
        got = (b6.segment_minmax_bwd(B, mm, cnt, g_mm, rp, send), None)
        want = (b6.minmax_dh_plain(B, mm_p, cnt_p, g_mm, rp, send), None)
        fn = lambda b, w: (b6.segment_minmax(b, seg),)  # noqa: E731
        cots = (g_mm,)
    else:
        out, mm2, cnt2 = b58.dgn_fused_fwd(B, W, rp, send)
        assert torch.equal(mm2, mm_p) and torch.equal(cnt2, cnt_p)
        got = b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, rp, send, True)
        want = b58.dgn_fused_bwd_plain(B, W, g_w, mm_p, cnt_p, g_mm, rp,
                                       send, True)
        fn = lambda b, w: b58.dgn_fused(b, w, seg)  # noqa: E731
        cots = (g_w, g_mm)
    if weighted:
        assert out.dtype == torch.float32
        torch.testing.assert_close(
            out, b58.weighted_gather_fwd_plain(B, W, rp, send), **FWD)
        grad_close([got[1]], [want[1]])
    bf16_close(got[0], want[0])

    Bl = B.clone().requires_grad_(True)
    Wl = W.clone().requires_grad_(weighted)
    outs = fn(Bl, Wl)
    leaves = [Bl, Wl] if weighted else [Bl]
    grads = torch.autograd.grad(
        sum((o.float() * c).sum() for o, c in zip(outs, cots)), leaves)
    bf16_close(grads[0], k3.segment_sum_sorted_plain(
        got[0], seg.send_ptr, seg.send_perm, torch.bfloat16))
    if weighted:
        grad_close(grads[1:], [want[1]])


@pytest.mark.parametrize("d", [128, 300, 33])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("has_a,has_pe", [(True, True), (False, False)])
def test_edge_message_id_sq(dev, d, dtype, has_a, has_pe):
    """K1/K2 in the fused-BN moments mode: the f32 [N, 2d] sums of
    [H, H²] and the f32 dH = g1 + 2H·g2 at the f32 tolerances, dA in the
    data dtype; the autograd Function's dA, dB (K3 f32 -> data dtype),
    dPe and db1 against the plain backward."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    rng = np.random.RandomState(d + 5)
    n, e, slots = 300, 900, 1000
    seg = k12.EdgeSegments(*(t.to(dev)
                             for t in ragged_segments(rng, n, e)))
    gen = torch.Generator(device=dev).manual_seed(d + 1)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dt)

    A = rnd(n, d) if has_a else None
    B = rnd(n, d)
    Pe = rnd(slots, d) if has_pe else None
    b1 = torch.randn(d, device=dev, generator=gen)
    g = torch.randn(n, 2 * d, device=dev, generator=gen)
    rp, send = seg.recv_ptr, seg.send
    hs = k12.edge_message_fwd(A, B, Pe, b1, rp, send, "id_sq")
    assert hs.dtype == torch.float32 and hs.shape == (n, 2 * d)
    torch.testing.assert_close(
        hs, k12.edge_message_fwd_plain(A, B, Pe, b1, rp, send, "id_sq"),
        **FWD)
    dH, dA = k12.edge_message_bwd_recv(A, B, Pe, b1, g, rp, send, "id_sq",
                                       slots)
    dH_p, dA_p = k12.edge_message_bwd_recv_plain(A, B, Pe, b1, g, rp, send,
                                                 "id_sq", slots)
    assert dH.dtype == torch.float32
    torch.testing.assert_close(dH, dH_p, **FWD)
    close = bf16_close if dt == torch.bfloat16 else (
        lambda a, b: grad_close([a], [b]))
    if has_a:
        assert dA.dtype == dt
        close(dA, dA_p)
    leaves = [t.clone().requires_grad_(True) for t in (A, B, Pe, b1)
              if t is not None]
    it = iter(leaves)
    args = [next(it) if t is not None else None for t in (A, B, Pe, b1)]
    got = torch.autograd.grad(
        (k12.edge_message_aggregate(*args, seg, "id_sq") * g).sum(), leaves)
    want = ([dA_p] if has_a else []) + [k3.segment_sum_sorted_plain(
        dH_p, seg.send_ptr, seg.send_perm, dt)] + (
            [dH_p.to(dt)] if has_pe else [])
    for a, b in zip(got[:-1], want):
        assert a.dtype == dt
        close(a, b)
    assert got[-1].dtype == torch.float32
    grad_close([got[-1]], [dH_p.sum(0)])


@pytest.mark.parametrize("d", [128, 33])
def test_segment_sum_kernel_f32_to_bf16(dev, d):
    """K3 from f32 rows into bf16 (the fused-BN pass's dB): the f32 sum
    rounded once, within one bf16 ulp of the plain version's."""
    rng = np.random.RandomState(d + 9)
    recv_ptr, send, send_ptr, perm = (t.to(dev) for t in
                                      ragged_segments(rng, 200, 700))
    rows = torch.randn(700, d, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(d))
    for ptr, p in ((send_ptr, perm), (recv_ptr, None)):
        bf16_close(k3.segment_sum_sorted(rows, ptr, p, torch.bfloat16),
                   k3.segment_sum_sorted_plain(rows, ptr, p, torch.bfloat16))


# ---------------------------------------------------------------------------
# K1-K3 across widths, K3's two forms (chip_smoke.py phase 33's sweep)
# ---------------------------------------------------------------------------

SWEEP_LENGTHS = (0, 1, 2, 3, 4, 5, 0, 7, 8, 9, 16, 31, 32, 33, 0, 64, 100,
                 257, 1000, 2000)


def sweep_layout(dev):
    """SWEEP_LENGTHS and 300 segments of 0-4 rows: (K3's ptr starting 13
    rows in, over rows of which 29 trail; a permutation of the rows; K1's
    recv_ptr over the same lengths; a sender for each edge; rows)."""
    rng = np.random.RandomState(9)
    lengths = np.r_[SWEEP_LENGTHS, rng.randint(0, 5, 300)]
    ends = np.cumsum(lengths)
    n_rows = 13 + int(ends[-1]) + 29
    return (*[torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        np.r_[13, 13 + ends], rng.permutation(n_rows), np.r_[0, ends],
        rng.randint(0, len(lengths), int(ends[-1])))], n_rows)


def order_close(got, want, abs_sum, counts):
    """Sums of the same terms in another order: bf16 within one ulp; f32
    within the f32 tolerances plus 2 (n - 1) 2^-24 S for a row of n terms
    whose absolute values sum to S (the worst-case rounding of two f32
    sums: the long rows cancel)."""
    if want.dtype == torch.bfloat16:
        return bf16_close(got, want)
    slack = 2 * (counts - 1).clamp(min=0)[:, None] * 2.0 ** -24 * abs_sum
    err = (got - want).abs()
    assert bool((err <= 2e-5 + 2e-4 * want.abs() + slack).all()), float(
        err.max())


@pytest.mark.parametrize("d", [2, 6, 37, 75, 150, 298])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segment_sum_forms_across_widths(dev, d, dtype):
    """K3 in both forms, with and without perm, into f32 and bf16, over
    empty segments and segments of 1 to 2,000 rows; each call repeated
    gives the same bits."""
    ptr, perm, _, _, n_rows = sweep_layout(dev)
    t_in = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = torch.randn(n_rows, d, device=dev, generator=torch.Generator(
        device=dev).manual_seed(d)).to(t_in)
    for form in k3.FORMS:
        for p in (None, perm):
            abs_sum = k3.segment_sum_sorted_plain(x.abs(), ptr, p)
            for t_out in (torch.float32, torch.bfloat16):
                got = k3.segment_sum_sorted_in(form, x, ptr, p, t_out)
                assert got.dtype == t_out
                order_close(got, k3.segment_sum_sorted_plain(x, ptr, p,
                                                             t_out),
                            abs_sum, ptr.diff())
                assert torch.equal(got, k3.segment_sum_sorted_in(
                    form, x, ptr, p, t_out))


@pytest.mark.parametrize("d", [2, 6, 37, 75, 150, 298])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["relu", "identity", "id_sq"])
def test_edge_message_fwd_across_widths(dev, d, dtype, act):
    """K1 in each mode, with and without A and Pe, over receivers with
    no edges and with 1 to 2,000."""
    _, _, recv_ptr, send, _ = sweep_layout(dev)
    n, e = recv_ptr.numel() - 1, send.numel()
    gen = torch.Generator(device=dev).manual_seed(d)
    t = torch.bfloat16 if dtype == "bf16" else torch.float32
    A, B = (torch.randn(n, d, device=dev, generator=gen).to(t)
            for _ in range(2))
    Pe = torch.randn(e + 29, d, device=dev, generator=gen).to(t)
    b1 = torch.randn(d, device=dev, generator=gen)
    recv = k12.receivers(recv_ptr)
    for a, pe in ((A, Pe), (None, Pe), (A, None), (None, None)):
        h = k12._pre_activation(a, B, pe, b1, recv, send).abs()
        if act == "id_sq":
            h = torch.cat([h, h * h], dim=1)
        abs_sum = torch.zeros(n, h.shape[1], device=dev).index_add_(
            0, recv, h)
        order_close(k12.edge_message_fwd(a, B, pe, b1, recv_ptr, send, act),
                    k12.edge_message_fwd_plain(a, B, pe, b1, recv_ptr, send,
                                               act), abs_sum,
                    recv_ptr.diff())


@pytest.mark.parametrize("d", [2, 6, 37, 75, 150, 298])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["relu", "identity", "id_sq"])
def test_edge_message_bwd_recv_across_widths(dev, d, dtype, act):
    """K2 in each mode, with and without A and Pe, over receivers with
    no edges and with 1 to 2,000: relu and identity dH bit for bit (a
    masked copy of g), id_sq's f32 dH at the f32 tolerances (the kernel
    contracts g1 + 2 H g2 into one rounding), dA as a sum in another
    order, and a repeated call with the same bits."""
    _, _, recv_ptr, send, _ = sweep_layout(dev)
    n, e = recv_ptr.numel() - 1, send.numel()
    gen = torch.Generator(device=dev).manual_seed(d)
    t = torch.bfloat16 if dtype == "bf16" else torch.float32
    A, B = (torch.randn(n, d, device=dev, generator=gen).to(t)
            for _ in range(2))
    Pe = torch.randn(e + 29, d, device=dev, generator=gen).to(t)
    b1 = torch.randn(d, device=dev, generator=gen)
    g = torch.randn(n, 2 * d if act == "id_sq" else d, device=dev,
                    generator=gen)
    if act != "id_sq":
        g = g.to(t)
    recv = k12.receivers(recv_ptr)
    for a, pe in ((A, Pe), (None, Pe), (A, None), (None, None)):
        dH, dA = k12.edge_message_bwd_recv(a, B, pe, b1, g, recv_ptr, send,
                                           act, e + 29)
        dH_p, dA_p = k12.edge_message_bwd_recv_plain(a, B, pe, b1, g,
                                                     recv_ptr, send, act,
                                                     e + 29)
        if act == "id_sq":
            torch.testing.assert_close(dH, dH_p, **FWD)
        else:
            assert dH.dtype == dH_p.dtype and torch.equal(dH, dH_p)
        assert (dA is None) == (a is None)
        if a is not None:
            abs_sum = torch.zeros(n, d, device=dev).index_add_(
                0, recv, dH_p[:e].float().abs())
            order_close(dA, dA_p, abs_sum, recv_ptr.diff())
        dH2, dA2 = k12.edge_message_bwd_recv(a, B, pe, b1, g, recv_ptr,
                                             send, act, e + 29)
        assert torch.equal(dH, dH2)
        assert a is None or torch.equal(dA, dA2)


@pytest.mark.parametrize("n_seg,length,form", [
    (1056, 16, "block"), (1057, 16, "warp"),    # one wave of blocks
    (128, 15, "warp"), (128, 16, "block"),      # 16 rows a segment
    (64, 2000, "block"), (4096, 2, "warp")])
def test_segment_sum_sorted_takes_the_chosen_form(dev, n_seg, length,
                                                  form):
    """segment_sum_sorted launches the form segment_sum_form picks, on
    either side of its thresholds, and agrees with the plain version; the
    block form gives the same bits on every call."""
    ptr = torch.arange(n_seg + 1, dtype=torch.int32, device=dev) * length
    x = torch.randn(n_seg * length, 150, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    assert k3.segment_sum_form(n_seg, n_seg * length) == form
    before = dict(k3.segment_sum_sorted.forms)
    got = k3.segment_sum_sorted(x, ptr)
    assert k3.segment_sum_sorted.forms.get(form, 0) == before.get(form,
                                                                  0) + 1
    order_close(got, k3.segment_sum_sorted_plain(x, ptr),
                k3.segment_sum_sorted_plain(x.abs(), ptr), ptr.diff())
    for _ in range(3):
        assert torch.equal(got, k3.segment_sum_sorted(x, ptr))


# ---------------------------------------------------------------------------
# the split sender space (edge partitioning) and repeatable receiver sums
# ---------------------------------------------------------------------------

def ep_shards(dev, D=4):
    """``make_zinc_like(256)``'s batch and its D edge-partitioned shards
    on the card."""
    from gsn_tpu_torch.data.synthetic import make_zinc_like
    from gsn_tpu_torch.graphs.batching import iterate_batches
    from gsn_tpu_torch.parallel import make_ep_batch
    graphs, _ = make_zinc_like(256)
    data = next(iterate_batches(graphs, 256, y_dtype=np.float32))
    return data.to(dev), [s.to(dev) for s in make_ep_batch(data, D)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["relu", "id_sq"])
def test_edge_message_split_sender_space(dev, dtype, act):
    """K1, K2 and K3 (dB into the N sender rows) with B in the gathered
    sender space of D=4 edge-partitioned shards (A, g and the output
    over a shard's 1/4 of the rows): each shard against the plain
    versions, and the shards' stacked K1 outputs equal the unpartitioned
    K1's bit for bit."""
    from gsn_tpu_torch.nn.models import edge_segments
    data, shards = ep_shards(dev)
    N, d = data.num_node_slots, 128
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(2)
    A, B = (torch.randn(N, d, device=dev, generator=gen).to(dt)
            for _ in range(2))
    Pe = torch.randn(data.num_edge_slots, d, device=dev,
                     generator=gen).to(dt)
    b1 = torch.randn(d, device=dev, generator=gen)
    width = 2 * d if act == "id_sq" else d
    g = torch.randn(N, width, device=dev, generator=gen)
    g = g if act == "id_sq" else g.to(dt)
    close = (lambda a, b: torch.testing.assert_close(a, b, **FWD)) \
        if dt == torch.float32 or act == "id_sq" else bf16_close
    block, e0, outs = N // len(shards), 0, []
    for r, shard in enumerate(shards):
        seg = edge_segments(shard)
        n = shard.num_real_edges
        rows = slice(r * block, (r + 1) * block)
        a, pe, gr = A[rows], Pe[e0:e0 + n], g[rows]
        # Pe holds the shard's real edges only: so does send
        send = seg.send[:n]
        out = k12.edge_message_fwd(a, B, pe, b1, seg.recv_ptr, send, act)
        close(out, k12.edge_message_fwd_plain(a, B, pe, b1, seg.recv_ptr,
                                              send, act))
        dH, dA = k12.edge_message_bwd_recv(a, B, pe, b1, gr, seg.recv_ptr,
                                           send, act, n + 7)
        dH_p, dA_p = k12.edge_message_bwd_recv_plain(
            a, B, pe, b1, gr, seg.recv_ptr, send, act, n + 7)
        if act == "id_sq":
            torch.testing.assert_close(dH, dH_p, **FWD)
        else:
            assert torch.equal(dH, dH_p)
        (close if dt == torch.float32 else bf16_close)(dA, dA_p)
        dB = k3.segment_sum_sorted(dH, seg.send_ptr, seg.send_perm, dt)
        dB_p = k3.segment_sum_sorted_plain(dH, seg.send_ptr, seg.send_perm,
                                           dt)
        assert dB.shape == (N, d)
        (close if dt == torch.float32 else bf16_close)(dB, dB_p)
        outs.append(out)
        e0 += n
    whole = edge_segments(data)
    assert torch.equal(torch.cat(outs), k12.edge_message_fwd(
        A, B, Pe, b1, whole.recv_ptr, whole.send, act))


def test_receiver_sums_repeat_bit_for_bit(dev):
    """Two runs of 3 train steps from one seed give the same losses and
    weights bit for bit: a zinc model with ``aggr="mean"`` and a DGN
    model with ``var`` and ``std`` (their receiver sums are K3 over
    ``recv_ptr``, one order per receiver)."""
    from gsn_tpu_torch.config import GSNConfig
    from gsn_tpu_torch.data.synthetic import make_dgn_like, make_zinc_like
    from gsn_tpu_torch.graphs.batching import iterate_batches
    from gsn_tpu_torch.nn.dgn import DGNConfig, DGNNet, compute_avg_d
    from gsn_tpu_torch.train.loop import Trainer, TrainerConfig

    graphs, d_id = make_zinc_like(128)
    zinc = GSNConfig(
        model_name="GSN_edge_sparse", num_layers=2, d_out=64,
        out_features=1, msg_kind="general", id_scope="global",
        bn_mlp=False, id_embedding="one_hot_encoder",
        input_node_encoder="embedding", edge_encoder="embedding",
        readout="sum", in_features=1, d_in_node_encoder=[28],
        d_in_edge_encoder=[4], d_in_id=d_id, aggr="mean")
    dgn_graphs = make_dgn_like(128)
    dgn_cfg = DGNConfig(hidden_dim=32, out_dim=32, num_layers=2,
                        aggregators=("mean", "max", "var", "std",
                                     "dir0-av"),
                        avg_d=compute_avg_d(dgn_graphs), dropout=0.0)
    tc = TrainerConfig(lr=1e-3, batch_size=128, loss_fn="L1Loss",
                       scheduler="None")
    for cfg, gs, model in ((zinc, graphs, None),
                           (dgn_cfg, dgn_graphs, DGNNet(dgn_cfg))):
        runs = []
        for _ in range(2):
            tr = Trainer(cfg, tc, gs, device=dev, model=model)
            st = tr.init_state(seed=0)
            data = tr.to_device(next(iterate_batches(
                gs, 128, y_dtype=np.float32, flow=tr.flow)))
            losses = [float(tr.train_step(st, data)[1]) for _ in range(3)]
            runs.append((losses, [p.detach().clone()
                                  for p in st.model.parameters()]))
        assert runs[0][0] == runs[1][0]
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1],
                                                     runs[1][1]))


def zinc_cli_gather_grads(dev, num_graphs):
    """(prediction, {name: gradient}) of one train-mode L1 step of the
    500K ZINC model (d=150, 4 layers, f32 ``bn_mlp`` messages on the
    per-edge path) from one seed, on ``num_graphs`` molecules under
    zinc-cli's caps (5,504 node and 13,184 edge slots, 128 graphs)."""
    from gsn_tpu_torch.config import GSNConfig
    from gsn_tpu_torch.data.synthetic import make_zinc_like
    from gsn_tpu_torch.graphs.batching import iterate_batches
    from gsn_tpu_torch.nn.models import build_model
    from gsn_tpu_torch.train import metrics
    graphs, d_id = make_zinc_like(num_graphs)
    cfg = GSNConfig(
        model_name="GSN_edge_sparse", num_layers=4, d_out=150,
        out_features=1, msg_kind="general", id_scope="global",
        bn_mlp=True, id_embedding="one_hot_encoder",
        input_node_encoder="one_hot_encoder",
        edge_encoder="one_hot_encoder", jk_mlp=True,
        final_projection=[False], readout="sum", in_features=1,
        d_in_node_encoder=[28], d_in_edge_encoder=[4], d_in_id=d_id)
    batch = next(iterate_batches(graphs, num_graphs,
                                 caps=(5504, 13184, 128),
                                 y_dtype=np.float32)).to(dev)
    model = build_model(cfg, torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    out = model(batch)
    metrics.l1_loss(out, batch.y, batch.graph_mask).backward()
    return out.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("num_graphs", [128, 16])
def test_edge_gathers_backward_on_zinc_cli_shapes(dev, monkeypatch,
                                                  num_graphs):
    """The per-edge gathers' backward through K3 over the batch's
    segments, on a full batch and on an epoch's last batch of 16 graphs
    (most slots padding): K3 13 a step (4 receiver sums, 8 gathers, the
    pool), two runs of one seed with the same gradients bit for bit, and
    the gradients of the index route (``x[idx]``'s own backward) at the
    f32 tolerances, with the same prediction bits."""
    from gsn_tpu_torch.nn import filters
    before = k3.segment_sum_sorted.launches
    out, got = zinc_cli_gather_grads(dev, num_graphs)
    assert k3.segment_sum_sorted.launches - before == 13
    out2, again = zinc_cli_gather_grads(dev, num_graphs)
    assert torch.equal(out, out2)
    for name, g in got.items():
        assert torch.equal(g, again[name]), name
    gather = filters.edge_gather
    monkeypatch.setattr(filters, "edge_gather",
                        lambda rows, idx, seg, side:
                        gather(rows, idx, None, side))
    before = k3.segment_sum_sorted.launches
    out_i, want = zinc_cli_gather_grads(dev, num_graphs)
    assert k3.segment_sum_sorted.launches - before == 5
    assert torch.equal(out, out_i)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=2e-3,
                                   atol=1e-4 * scale, msg=name)


def test_edge_partitioned_propagates_on_the_card(dev):
    """Both edge-partitioned propagates over an NCCL group of one
    (``parallel.distributed.initialize``) on a graph of 1,024 nodes with
    a hub receiver: forward and the gradient of Σ out·cot against their
    plain versions on the CPU (one device, ``index_add``); each is one K3
    launch forward and one K4 backward."""
    import socket

    from gsn_tpu_torch.ops.cuda import build
    from gsn_tpu_torch.ops.segment import masked_segment_sum
    from gsn_tpu_torch.parallel import distributed
    from gsn_tpu_torch.parallel import edge_partition as ep

    n, e, d = 1024, 6000, 70
    rng = np.random.RandomState(3)
    ei = np.stack([rng.randint(0, n, e), rng.randint(0, n, e)])
    ei[0, :200] = 7
    x = rng.randn(n, d).astype(np.float32)
    cot = rng.randn(n, d).astype(np.float32)

    def message(xi, xj):
        return torch.tanh(xi) + 2.0 * xj

    x_cpu = torch.from_numpy(x).requires_grad_(True)
    recv, send = (torch.from_numpy(a).long() for a in ei)
    want = masked_segment_sum(message(x_cpu[recv], x_cpu[send]), recv, n)
    (want_g,) = torch.autograd.grad((want * torch.from_numpy(cot)).sum(),
                                    [x_cpu])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = distributed.global_mesh("ep")
        for partition, propagate in (
                (ep.partition_edges_by_receiver,
                 ep.edge_partitioned_propagate),
                (ep.partition_edges_ring,
                 ep.ring_edge_partitioned_propagate)):
            prop = propagate(mesh, message)
            args = ep.rank_inputs(partition(ei, n, 1), 0, dev)
            for fn in (k3.segment_sum_sorted, k4.segment_broadcast):
                build.reset(fn)
            xs = torch.from_numpy(x).to(dev).requires_grad_(True)
            y = prop(xs, *args)
            (g,) = torch.autograd.grad(
                (y * torch.from_numpy(cot).to(dev)).sum(), [xs])
            assert (k3.segment_sum_sorted.launches,
                    k4.segment_broadcast.launches) == (1, 1)
            torch.testing.assert_close(y.cpu(), want.detach(), **FWD)
            torch.testing.assert_close(
                g.cpu(), want_g, rtol=2e-3,
                atol=1e-4 * float(want_g.abs().max()))
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# one-dispatch epochs: the train and eval steps as CUDA graphs
# ---------------------------------------------------------------------------

def graphed_zinc(num_graphs=48, seed=3):
    """A small ``zinc_cfg`` (d=16, 2 layers, BN) and its graphs."""
    from gsn_tpu_torch.config import GSNConfig
    from gsn_tpu_torch.data.synthetic import make_zinc_like
    graphs, d_id = make_zinc_like(num_graphs, seed=seed)
    cfg = GSNConfig(model_name="GSN_edge_sparse", num_layers=2, d_out=16,
                    out_features=1, msg_kind="general", id_scope="global",
                    bn_mlp=False, id_embedding="one_hot_encoder",
                    input_node_encoder="embedding", edge_encoder="embedding",
                    readout="sum", in_features=1, d_in_node_encoder=[28],
                    d_in_edge_encoder=[4], d_in_id=d_id)
    return graphs, cfg


def zinc_epochs(dev, scan, epochs=2, lr_at=None, model=None,
                scheduler="None"):
    """(epoch losses, evaluations, final parameters, trainer) of a small
    zinc run on the card; ``lr_at``: {epoch: rate} set on the scheduler
    before that epoch."""
    from gsn_tpu_torch.train.loop import Trainer, TrainerConfig
    graphs, cfg = graphed_zinc()
    tcfg = TrainerConfig(lr=1e-3, batch_size=8, scheduler=scheduler,
                         loss_fn="L1Loss", prediction_fn="L1Loss", seed=2,
                         scan_epochs=scan)
    trainer = Trainer(cfg, tcfg, graphs[:40], device=dev, model=model)
    state = trainer.init_state(seed=0)
    losses, evals = [], []
    for e in range(epochs):
        if lr_at and e in lr_at:
            trainer.scheduler.current_lr = lr_at[e]
        state, loss = trainer.train_epoch(state, graphs[:40])
        losses.append(loss)
        evals.append(trainer.evaluate(state, graphs[40:]))
    params = {k: v.detach().clone() for k, v in
              state.model.state_dict().items()}
    return losses, evals, params, trainer


def test_graphed_epochs_equal_per_step(dev):
    """Two graphed epochs (train and eval replays) against two per-step
    epochs of the same seed and weights: losses, evaluations and every
    parameter and BN statistic bit for bit; the second graphed epoch
    captures nothing and launches what the per-step epoch does."""
    from gsn_tpu_torch.ops.cuda import build
    graphed = zinc_epochs(dev, True)
    assert graphed[3].epoch_stats["capture_s"] == 0.0
    assert all(g.captured for g in graphed[3]._graphs.values())
    counted = [k3.segment_sum_sorted, k4.segment_broadcast,
               k12.edge_message_fwd, k12.edge_message_bwd_recv]
    per_step = zinc_epochs(dev, False)
    assert graphed[0] == per_step[0] and graphed[1] == per_step[1]
    for k, v in per_step[2].items():
        assert torch.equal(graphed[2][k], v), k
    # one more epoch of each: the launch counts agree
    counts = []
    train = graphed_zinc()[0][:40]
    for run in (graphed, per_step):
        trainer = run[3]
        state = trainer.init_state(seed=0)
        state, _ = trainer.train_epoch(state, train)
        for fn in counted:
            build.reset(fn)
        trainer.train_epoch(state, train)
        counts.append([(fn.launches, dict(fn.modes)) for fn in counted])
    assert counts[0] == counts[1] and counts[0][0][0] > 0


def test_graphed_epoch_builds_between_replays(dev, monkeypatch):
    """On the card a graphed epoch builds batch k+1 after step k is
    issued; every step fed after a replay counts as overlapped: all but
    the first two of the capturing epoch (its first step captures), all
    but the first once the graph is cached, none per step."""
    from gsn_tpu_torch.graphs import batching
    from gsn_tpu_torch.train import loop
    graphs, _cfg = graphed_zinc()
    order = []
    build_batch, step = batching.batch_graphs, loop.StepGraph.step
    monkeypatch.setattr(batching, "batch_graphs", lambda *a, **k: (
        order.append("build"), build_batch(*a, **k))[1])
    monkeypatch.setattr(loop.StepGraph, "step", lambda g, st: (
        order.append("step"), step(g, st))[1])
    got = []
    for scan in (True, False):
        trainer = zinc_epochs(dev, scan, epochs=1)[3]
        state = trainer.init_state(seed=0)
        for _ in range(2):
            order.clear()
            state, _ = trainer.train_epoch(state, graphs[:40])
            got.append(trainer.epoch_stats["train.overlapped_batches"])
            if scan:
                assert order == ["build", "step"] * 5
    assert got == [3, 4, 0, 0]


def test_graphed_plateau_rate_reaches_replays(dev):
    """A rate set on the Plateau scheduler between epochs reaches the
    replayed Adam: the graphed run equals the per-step run bit for bit
    through a halving, and at rate 0 a replayed epoch leaves every
    parameter as it was."""
    lr_at = {1: 5e-4, 2: 0.0}
    graphed = zinc_epochs(dev, True, 3, lr_at, scheduler="ReduceLROnPlateau")
    per_step = zinc_epochs(dev, False, 3, lr_at,
                           scheduler="ReduceLROnPlateau")
    assert graphed[0] == per_step[0]
    for k, v in per_step[2].items():
        assert torch.equal(graphed[2][k], v), k
    trainer, train = graphed[3], graphed_zinc()[0][:40]
    state = trainer.init_state(seed=0)
    trainer.scheduler.current_lr = 0.0
    state, _ = trainer.train_epoch(state, train)
    before = [p.detach().clone() for p in state.model.parameters()]
    state, _ = trainer.train_epoch(state, train)
    assert trainer.epoch_stats["capture_s"] == 0.0
    for a, p in zip(before, state.model.parameters()):
        assert torch.equal(a, p)


def test_capture_unsafe_step_raises(dev):
    """A step that reads the device from the host (``.item()``) cannot be
    captured: ``train_epoch`` raises, and runs nothing per step in its
    place."""
    from gsn_tpu_torch.nn.models import GNNSubstructures

    class ReadsBack(GNNSubstructures):
        def forward(self, data, generator=None, noise=None):
            out = super().forward(data, generator, noise)
            if out.sum().item() == float("nan"):   # a host read
                raise AssertionError("unreachable")
            return out

    _graphs, cfg = graphed_zinc()
    with pytest.raises(RuntimeError):
        zinc_epochs(dev, True, 1, model=ReadsBack(cfg.finalize()))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# graphed parallel epochs: dp and ep steps, their NCCL collectives inside
# ---------------------------------------------------------------------------

def parallel_epochs(dev, mode, scan, evaluator=None, epochs=2):
    """(epoch losses, evaluations, final parameters, trainer) of the small
    zinc run under ``ParallelTrainer`` ``mode`` on the process group;
    ``evaluator="rocauc"``: BCE on 0/1 labels with the ROC-AUC pack."""
    from gsn_tpu_torch.parallel import ParallelTrainer, distributed
    from gsn_tpu_torch.train.loop import TrainerConfig
    graphs, cfg = graphed_zinc()
    kw = dict(loss_fn="L1Loss", prediction_fn="L1Loss")
    if evaluator is not None:
        graphs = [dict(g, y=np.array([float(g["y"] > 0)], np.float32))
                  for g in graphs]
        kw = dict(loss_fn="BCEWithLogitsLoss", prediction_fn="None",
                  evaluator=evaluator)
    tcfg = TrainerConfig(lr=1e-3, batch_size=8, scheduler="None", seed=2,
                         scan_epochs=scan, **kw)
    trainer = ParallelTrainer(cfg, tcfg, graphs[:40],
                              mesh=distributed.global_mesh(mode), mode=mode)
    assert trainer.tcfg.scan_epochs is scan
    assert trainer.device.type == dev.type
    state = trainer.init_state(seed=0)
    losses, evals = [], []
    for _ in range(epochs):
        state, loss = trainer.train_epoch(state, graphs[:40])
        losses.append(loss)
        evals.append(trainer.evaluate(state, graphs[40:]))
    params = {k: v.detach().clone() for k, v in
              state.model.state_dict().items()}
    return losses, evals, params, trainer


@pytest.fixture
def nccl_group(dev):
    """An NCCL group of one in this process (``distributed.initialize``),
    left when the test ends."""
    import socket

    from gsn_tpu_torch.parallel import distributed
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        yield dev
    finally:
        distributed.shutdown()


@pytest.mark.parametrize("mode,evaluator", [("dp", None), ("ep", None),
                                            ("dp", "rocauc")])
def test_graphed_parallel_epochs_equal_per_step(nccl_group, mode,
                                                evaluator):
    """``ParallelTrainer`` on one NCCL rank: two graphed epochs (the train
    and eval steps with their all-reduces, all-gathers and reduce-scatters
    captured) against two per-step epochs of the same seed and weights,
    losses, evaluations (the ROC-AUC pack all-gathered on the device) and
    every parameter and BN statistic bit for bit; a fresh state's second
    graphed epoch captures nothing and launches what a per-step epoch
    does."""
    from gsn_tpu_torch.ops.cuda import build
    dev = nccl_group
    graphed = parallel_epochs(dev, mode, True, evaluator)
    per_step = parallel_epochs(dev, mode, False, evaluator)
    assert graphed[0] == per_step[0] and graphed[1] == per_step[1]
    for k, v in per_step[2].items():
        assert torch.equal(graphed[2][k], v), k
    counted = [k3.segment_sum_sorted, k4.segment_broadcast,
               k12.edge_message_fwd, k12.edge_message_bwd_recv]
    counts = []
    train = graphed_zinc()[0][:40]
    if evaluator is not None:
        train = [dict(g, y=np.array([float(g["y"] > 0)], np.float32))
                 for g in train]
    for run in (graphed, per_step):
        trainer = run[3]
        state = trainer.init_state(seed=0)
        state, _ = trainer.train_epoch(state, train)
        for fn in counted:
            build.reset(fn)
        trainer.train_epoch(state, train)
        counts.append([(fn.launches, dict(fn.modes)) for fn in counted])
    assert graphed[3].epoch_stats["capture_s"] == 0.0
    assert counts[0] == counts[1] and counts[0][0][0] > 0
