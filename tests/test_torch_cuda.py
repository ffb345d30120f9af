"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a card; on a
machine with one (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small and ragged (empty segments, a width that is not a
multiple of 4 next to one that is) so both the float4 and the scalar
paths run.  Tolerances: forward rtol 2e-4 / atol 2e-5, gradients rtol
2e-3 / atol 1e-4 * max|g|.
"""

import numpy as np
import pytest
import torch

from gsn_tpu_torch.ops.cuda import slab_combine as k3
from gsn_tpu_torch.ops.cuda import slab_message as k12
from gsn_tpu_torch.ops.cuda import slab_pool as k4

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
