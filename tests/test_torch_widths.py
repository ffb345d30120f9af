"""K1-K3's plain versions against the reference package's Pallas kernels
at the widths the redesigned K1-K3 target, on the CPU: the published
ZINC width (d=150, rows of 2-element accesses) and an odd one (d=37, one
element a lane), K2's ogb form also at molhiv's d=300; and K3's form
chooser.

The reference runs its kernels as its own tests do here (interpret
mode / the chunk-by-chunk emulation); the port runs its plain versions,
as its wrappers do on CPU tensors.  Tolerances: f32 forward rtol 2e-4 /
atol 2e-5 and gradients rtol 2e-3 / atol 1e-4 * max|g|
(tests/test_mxu_integration.py:48,79-84); bf16 data rtol 2e-2 / atol
1e-2 * max|want| (the reference rounds each chunk's partial sums to
bf16, the port has no chunks: tests/test_torch_bf16.py), except where
both copy bf16 values (dPe, the pool's backward): bit for bit.
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

FWD = dict(rtol=2e-4, atol=2e-5)
REL = 2e-2
WIDTHS = (150, 37)
BF = jnp.bfloat16


def f32(x):
    """A torch or jnp array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def data(a, bf):
    """(``a`` as the reference's jnp array, the same values as a torch
    tensor), both rounded to bf16 when ``bf``."""
    j = jnp.asarray(np.asarray(a, np.float32))
    if bf:
        j = j.astype(BF)
        return j, torch.from_numpy(np.array(f32(j))).to(torch.bfloat16)
    return j, torch.from_numpy(np.ascontiguousarray(a, np.float32))


def grad_close(got, want, err_msg=""):
    want = f32(want)
    np.testing.assert_allclose(f32(got), want, rtol=2e-3,
                               atol=1e-4 * float(np.abs(want).max()),
                               err_msg=err_msg)


def bf16_close(got, want, err_msg=""):
    want = f32(want)
    np.testing.assert_allclose(f32(got), want, rtol=REL,
                               atol=1e-2 * float(np.abs(want).max()),
                               err_msg=err_msg)


def csr(keys, num_segments):
    ptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=num_segments), out=ptr[1:])
    return torch.from_numpy(ptr.astype(np.int32))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "id_sq"])
def test_edge_message_matches_slab_kernel_at_width(d, dtype, act):
    """EdgeMessageAggregate (K1 forward; K2 and K3 for dA, dB; dPe, db1)
    against slab_edge_message_aggregate with ``data_dtype``: relu's
    output in the data dtype, id_sq's f32 [H, H^2] moments."""
    s = slab_setup(seed=d, d1=d, with_pe=True)
    N = s["N"]
    bf = dtype == "bfloat16"
    width = 2 * d if act == "id_sq" else d
    g_out = np.random.RandomState(d + 1).randn(s["num_nodes"], width
                                               ).astype(np.float32)
    A_j, A_t = data(s["A"], bf)
    B_j, B_t = data(s["B"], bf)
    Pe_j, Pe_t = data(s["Pe"], bf)

    def ref(A, B, Pe, b):
        return slab_edge_message_aggregate(
            A, B, Pe, b, jnp.asarray(s["meta"]["recv_local"]),
            jnp.asarray(s["meta"]["send_local"]), jnp.asarray(s["fb_wf"]),
            N, s["num_nodes"], BN, BE, act, True, True, None, dtype, True,
            s["meta"]["s_s"])

    args = (A_j, B_j, Pe_j, jnp.asarray(s["b1"]))
    out_ref = ref(*args)
    grads = jax.grad(lambda *a: jnp.sum(ref(*a).astype(jnp.float32)
                                        * g_out), argnums=(0, 1, 2, 3))(*args)

    send = s["send"].astype(np.int32)
    seg = k12.EdgeSegments(csr(s["recv"], N), torch.from_numpy(send),
                           csr(send, N), torch.from_numpy(
                               np.argsort(send, kind="stable")
                               .astype(np.int32)))
    leaves = {"A": A_t, "B": B_t, "Pe": Pe_t,
              "b1": torch.from_numpy(s["b1"])}
    for x in leaves.values():
        x.requires_grad_(True)
    out = k12.edge_message_aggregate(*leaves.values(), seg, act)
    assert out.shape == (N, width)
    assert out.dtype == (torch.bfloat16 if bf and act == "relu"
                         else torch.float32)
    if out.dtype == torch.bfloat16:
        bf16_close(out, out_ref[:N], "forward")
    else:
        np.testing.assert_allclose(f32(out), f32(out_ref)[:N], **FWD)
    (out.float() * torch.from_numpy(g_out[:N])).sum().backward()
    want = dict(zip(("A", "B", "Pe", "b1"), grads))
    for name in ("A", "B", "Pe"):
        got = leaves[name].grad
        assert got.dtype == leaves[name].dtype
        w = want[name] if name == "Pe" else want[name][:N]
        if not bf:
            grad_close(got, w, f"d{name}")
        elif name == "Pe" and act == "relu":
            np.testing.assert_array_equal(f32(got), f32(w), err_msg="dPe")
        else:
            bf16_close(got, w, f"d{name}")
    assert leaves["b1"].grad.dtype == torch.float32
    grad_close(leaves["b1"].grad, want["b1"], "db1")


# the forms the test above leaves out: identity with A and Pe, and the
# ogb message's (relu, no A side, Pe, a zero b1), also at molhiv's d=300
@pytest.mark.parametrize("form,d", [("identity", 150), ("identity", 37),
                                    ("ogb", 150), ("ogb", 37),
                                    ("ogb", 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_message_backward_forms_at_width(form, d, dtype):
    """EdgeMessageAggregate (K1 forward; K2 and K3 for dA, dB; dPe, db1)
    against jax.grad of slab_edge_message_aggregate with ``data_dtype``
    in the identity and ogb forms.  dPe is a copy (identity) or masked
    copy (relu) of the bf16 cotangent in both: bit for bit in bf16."""
    s = slab_setup(seed=d + 2, d1=d, with_pe=True)
    N = s["N"]
    bf = dtype == "bfloat16"
    has_a = form == "identity"
    act = "identity" if has_a else "relu"
    g_out = np.random.RandomState(d + 3).randn(s["num_nodes"], d).astype(
        np.float32)
    A_j, A_t = data(s["A"] if has_a else np.zeros_like(s["A"]), bf)
    B_j, B_t = data(s["B"], bf)
    Pe_j, Pe_t = data(s["Pe"], bf)
    b1 = s["b1"] if has_a else np.zeros(d, np.float32)

    def ref(A, B, Pe, b):
        return slab_edge_message_aggregate(
            A, B, Pe, b, jnp.asarray(s["meta"]["recv_local"]),
            jnp.asarray(s["meta"]["send_local"]), jnp.asarray(s["fb_wf"]),
            N, s["num_nodes"], BN, BE, act, True, True, None, dtype, has_a,
            s["meta"]["s_s"])

    args = (A_j, B_j, Pe_j, jnp.asarray(b1))
    out_ref = ref(*args)
    grads = jax.grad(lambda *a: jnp.sum(ref(*a).astype(jnp.float32)
                                        * g_out), argnums=(0, 1, 2, 3))(*args)

    send = s["send"].astype(np.int32)
    seg = k12.EdgeSegments(csr(s["recv"], N), torch.from_numpy(send),
                           csr(send, N), torch.from_numpy(
                               np.argsort(send, kind="stable")
                               .astype(np.int32)))
    leaves = {"A": A_t if has_a else None, "B": B_t, "Pe": Pe_t,
              "b1": torch.from_numpy(b1)}
    for x in leaves.values():
        if x is not None:
            x.requires_grad_(True)
    out = k12.edge_message_aggregate(*leaves.values(), seg, act)
    assert out.dtype == B_t.dtype
    if bf:
        bf16_close(out, out_ref[:N], "forward")
    else:
        np.testing.assert_allclose(f32(out), f32(out_ref)[:N], **FWD)
    (out.float() * torch.from_numpy(g_out[:N])).sum().backward()
    want = dict(zip(("A", "B", "Pe", "b1"), grads))
    for name in ("A", "B", "Pe"):
        if leaves[name] is None:
            continue
        got = leaves[name].grad
        assert got.dtype == leaves[name].dtype
        w = want[name] if name == "Pe" else want[name][:N]
        if not bf:
            grad_close(got, w, f"d{name}")
        elif name == "Pe":
            np.testing.assert_array_equal(f32(got), f32(w), err_msg="dPe")
        else:
            bf16_close(got, w, f"d{name}")
    assert leaves["b1"].grad.dtype == torch.float32
    grad_close(leaves["b1"].grad, want["b1"], "db1")


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("gathered", [False, True])
def test_segment_sum_matches_slab_combine_at_width(d, gathered):
    """K3's plain version, as a sorted segment sum over the slab rows,
    against slab_combine_sum: through ``perm`` or over rows already in
    segment order."""
    rng = np.random.RandomState(d)
    C, span, block_n, num_blocks = 17, 3, 8, 9
    key = np.sort(rng.randint(0, num_blocks - span + 1, C)).astype(np.int32)
    slabs = rng.randn(C, span * block_n, d).astype(np.float32)
    kc = combine_kc(key, span, num_blocks)
    want = np.asarray(slab_combine_sum(
        jnp.asarray(slabs), jnp.asarray(key), span, num_blocks, block_n, d,
        kc, interpret=True))
    tt, jj, ii = np.meshgrid(np.arange(C), np.arange(span),
                             np.arange(block_n), indexing="ij")
    out_row = ((key[tt] + jj) * block_n + ii).reshape(-1)
    rows = slabs.reshape(-1, d)
    perm = np.argsort(out_row, kind="stable").astype(np.int32)
    ptr = csr(out_row, num_blocks * block_n)
    if gathered:
        got = k3.segment_sum_sorted(torch.from_numpy(rows[perm]), ptr)
    else:
        got = k3.segment_sum_sorted(torch.from_numpy(rows), ptr,
                                    torch.from_numpy(perm))
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_pool_matches_slab_add_pool_at_width(d, dtype):
    """AddPool (K3 forward, K4 backward) against slab_add_pool over 40
    graphs of 1 to 300 nodes, every fifth empty, with 19 padding rows:
    the f32 pooled rows (from f32 or bf16 rows) and the backward, a copy
    of the cotangent in the rows' dtype, bit for bit."""
    rng = np.random.RandomState(d + 7)
    sizes = rng.randint(1, 301, 40)
    sizes[::5] = 0
    sizes[1], sizes[2] = 1, 300
    G, n_real = len(sizes), int(sizes.sum())
    n_rows = n_real + 19
    batch = np.zeros(n_rows, np.int32)
    mask = np.zeros(n_rows, bool)
    batch[:n_real] = np.repeat(np.arange(G), sizes)
    mask[:n_real] = True
    meta = build_pool_metadata(batch, mask, G, block_g=16, block_e=512)
    assert meta is not None
    n_pad = meta["recv_local"].shape[0]
    bf = dtype == "bfloat16"
    x_j, x_t = data(rng.randn(n_rows, d), bf)
    g = rng.randn(G, d).astype(np.float32)

    def ref(xp):
        return slab_add_pool(xp, jnp.asarray(meta["recv_local"]),
                             jnp.asarray(meta["fb"]), G, meta["block_g"],
                             meta["block_e"], True)

    out_ref, vjp = jax.vjp(ref, jnp.pad(x_j, ((0, n_pad - n_rows), (0, 0))))
    (dx_ref,) = vjp(jnp.asarray(g))
    ptr = torch.from_numpy(np.r_[0, np.cumsum(sizes)].astype(np.int32))
    xl = x_t.clone().requires_grad_(True)
    out = k4.add_pool(xl, ptr)
    assert out.dtype == torch.float32
    if bf:
        bf16_close(out, out_ref, "pool")
    else:
        np.testing.assert_allclose(f32(out), f32(out_ref), **FWD)
    assert not f32(out)[sizes == 0].any()
    out.backward(torch.from_numpy(g))
    assert xl.grad.dtype == x_t.dtype
    np.testing.assert_array_equal(f32(xl.grad), f32(dx_ref)[:n_rows])
    assert not f32(xl.grad)[~mask].any()


# zinc-cli's K3 shapes (scripts/zinc_10_runs.py --budget 500K through
# gsn_tpu_torch.cli, batch 128 at the trainer's worst-case caps; PERF.md §6):
# 128 graph slots over 5,504 node slots, 5,504 receivers over 13,184
# edge slots, 5,504 senders over 7,360 real edges.  The bench.py paths'
# pools: 1,024 graphs over ~25,000 node slots.
@pytest.mark.parametrize("n_seg,n_rows,want", [
    (128, 5504, "block"),      # zinc-cli's pool
    (5504, 13184, "warp"),     # zinc-cli's message sums over recv_ptr
    (5504, 7360, "warp"),      # zinc-cli's dB over send_perm
    (1024, 24987, "block"),    # the zinc path's pools (1024 graphs)
    (1057, 30000, "warp"),     # beyond one wave of resident blocks
    (128, 2047, "warp"),       # under 16 rows a segment on average
    (128, 2048, "block"),      # 16 rows a segment
    (0, 0, "warp"),
])
def test_segment_sum_form_by_shape(n_seg, n_rows, want):
    assert k3.segment_sum_form(n_seg, n_rows) == want


@pytest.mark.parametrize("args", [(-1, 10), (10, -1), (1.5, 10),
                                  (10, "7"), (True, 10)])
def test_segment_sum_form_rejects_bad_arguments(args):
    with pytest.raises(ValueError, match="segment_sum_form"):
        k3.segment_sum_form(*args)


def test_segment_sum_forms_take_cuda_tensors_only():
    rows = torch.randn(6, 150)
    ptr = torch.tensor([0, 2, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match="form"):
        k3.segment_sum_sorted_in("tree", rows, ptr)
    with pytest.raises(ValueError, match="CUDA"):
        k3.segment_sum_sorted_in("block", rows, ptr)
    before = k3.segment_sum_sorted.launches
    torch.testing.assert_close(k3.segment_sum_sorted(rows, ptr),
                               k3.segment_sum_sorted_plain(rows, ptr))
    assert k3.segment_sum_sorted.launches == before
