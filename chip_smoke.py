#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gsn_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure is an uncaught exception and a nonzero exit):

1. Print the card's name and power limit, turn TF32 off, build every
   CUDA kernel from ``gsn_tpu_torch/csrc`` (one ``nvcc`` per source, all
   at once) and print the build seconds.
2. Build the main path's batch: 1024 ZINC-like graphs with cycle counts
   k=3..8 (the port's copy of ``bench.py::make_zinc_like``), one batch at
   the tight epoch caps.
3. Hold each kernel (K1-K4) and both autograd Functions' backward passes
   against their plain PyTorch versions on the card at the main path's
   shapes (d=128), and time kernel, plain version and, where one exists,
   the one PyTorch call that computes the same function (device time;
   the kernel's host time to issue a call is reported beside it).
4. Check the whole model on a small batch: the card (kernels) against the
   CPU (plain versions), same weights, forward and gradients.
5. Drive the main path: the ZINC GSN-EF model (``bench.py::zinc_cfg``:
   d=128, 4 layers, random weights from seed 0) takes STEPS Adam steps on
   the batch through ``Trainer.train_step``.  The launch counters are
   zeroed just before and read just after; each kernel must have run
   its expected number of times per step.  Prints the median step time
   and edges/s.
6. Profile PROFILE_STEPS more steps with ``torch.profiler`` (after the
   timed ones, so the timing runs without it): device busy time per
   step, the device's idle share of the unprofiled median step, the
   kernels that take the most device time, and each of the port's own
   kernels' device time per launch inside the step.  A profiler that records no
   device time prints "not measured" and does not fail the run.
7. Build the DGN batch: 1024 molhiv-like graphs with the edge-level
   cycle-count vector field (the port's copy of
   ``bench.py::make_dgn_like``), one batch at the tight caps; print its
   real node and edge counts.
8. Hold the DGN kernels K5/K6 in each instantiation (B5
   ``weighted_gather``, B6 ``segment_minmax``, B8 ``dgn_fused``) and
   their autograd Functions against the plain versions at the DGN
   shapes (d=70, K=5 weight columns from the batch's own vector field,
   node rows after relu so maxima tie; tie counts exact), and time each
   as in phase 3.
9. Check a small DGN model (d=70, 2 layers, dropout 0) on the card
   against the CPU for one aggregator set per branch of the layer's
   kernel dispatch (fused, weighted only, minmax only); each branch must
   launch its kernels on the card.
10. Drive the DGN main path: ``bench.py::bench_dgn``'s configuration
    (d=70, 4 layers, 7 aggregators, dropout 0.3, BCE, Adam lr 1e-3)
    takes STEPS steps through ``Trainer.train_step``, launch counters
    zeroed just before and read just after, as in phase 5.
11. Drive the weighted-only and minmax-only paths at the same width and
    depth for BRANCH_STEPS steps each, counters zeroed before each.
12. Profile the DGN main path as phase 6 profiles the zinc one.
13. Build the molhiv batch: 1024 molhiv-like graphs (9 atom and 3 bond
    fields, induced edge-level cycle counts k=3..6 as ids; the port's
    copy of ``bench.py::make_molhiv_like``), one batch at the tight caps;
    print its real and slot node and edge counts.
14. Hold B4 (``graph_broadcast``: K4 forward, K3 backward) against its
    plain version at d=300, forward (padding rows exactly 0) and through
    autograd, and K1/K2 in the ogb message's form (no A side, Pe given,
    relu, zero b1) against theirs; time B4 as phase 3 times K4, and K1/K2
    in this form and B4's backward on log lines of their own.
15. Check a small ``GNN_OGB`` (d=32, 2 layers, virtual node, BN, dropout
    0) on the card against the CPU on a 60-graph batch in 64 graph slots;
    B4 and K1 must launch on the card.
16. Drive the molhiv main path: ``bench.py::molhiv_cfg`` (GSN-VN-AF:
    ``GNN_OGB``, ogb messages, local ids embedded to 300, d=300, hidden
    600, 5 layers, virtual node, dropout 0.5, mean readout, BCE, Adam lr
    1e-3) takes STEPS steps through ``Trainer.train_step``, launch
    counters zeroed just before and read just after (per step: K1 5, K2
    5, B4 5, K4 10, K3 15); prints the median step, real edges/s and peak
    memory.
17. Profile the molhiv main path as phase 6 profiles the zinc one.

Then it prints three lines: ``{"kernels": [...]}`` (each kernel's
checks, times, bound and its launches on the path named in its
``path``), the card's name and power limit, and last ``{"ok": true,
"device": {...}}``.  Without a CUDA card, or outside the repository, it
exits nonzero before printing any of them.
"""

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 20
PROFILE_STEPS = 5
D = 128
# bench.py::bench_dgn: width, aggregators (K=5 of them are weighted sums)
DGN_D = 70
DGN_AGGS = ("mean", "max", "min", "dir0-av", "dir1-av", "dir2-av",
            "dir3-av")
DGN_K = 5
# bench.py::molhiv_cfg: width (hidden 2x)
MOLHIV_D = 300
# one aggregator set per branch of the DGN layer's kernel dispatch
DGN_BRANCHES = {
    "fused": DGN_AGGS,
    "weighted": ("mean", "dir0-av", "dir1-av", "dir2-av", "dir3-av"),
    "minmax": ("max", "min"),
}
BRANCH_STEPS = 3
# f32 tolerances (tests/test_mxu_integration.py:48,79-84)
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
GRAD_RTOL = 2e-3
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def spin_cycles_per_ms():
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    cycles = 10 ** 7
    start, end = _events()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(fn, cycles_per_ms, iters=50, warmup=3):
    """(device ms, host ms) per call of ``fn`` over ``iters`` back-to-back
    calls.  A spin kernel holds the stream until every call is queued, so
    the CUDA events see the device time alone, not the host's cost of
    issuing each call through its Python wrapper; that cost is the host
    ms.  A ``fn`` that synchronises (the plain versions read
    data-dependent sizes back) pays its host time in the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    hold_ms = min(2e3 * (time.perf_counter() - t0), 500.0)
    start, end = _events()
    torch.cuda._sleep(int(hold_ms * cycles_per_ms))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def bound(nbytes, nops):
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, rtol, atol, what):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs err {err})")
    return err


def grad_check(got, want, what):
    atol = 1e-4 * max(float(w.abs().max()) for w in want)
    return max(max_err(g, w, GRAD_RTOL, atol, f"{what} d{i}")
               for i, (g, w) in enumerate(zip(got, want)))


def exact(got, want, what):
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version")


def train_steps(trainer, state, data, steps, counters):
    """``steps`` Adam steps; the launch counters are zeroed just before
    and read just after.  Returns (state, losses, step seconds,
    launches by name)."""
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, data)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {name: fn.launches for name, fn in counters.items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    return state, losses, step_s, launches


def expect_launches(launches, per_step, steps, what):
    """Every counter must show exactly its launches a step (0 for the
    kernels the path does not run)."""
    for name, n in launches.items():
        want = per_step.get(name, 0) * steps
        if n != want:
            raise AssertionError(f"{what}: {name} launched {n} times in "
                                 f"{steps} steps, expected {want}")


def profile_steps(trainer, state, data, step_ms, tag):
    """Phases 6, 12 and 17 (see module docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    # only the profiler's own start and stop may be refused; a failure in
    # the steps themselves propagates and fails the run
    prof = profile(activities=acts)
    try:
        prof.start()
    except RuntimeError as exc:
        log(f"[profile {tag}] not measured ({exc})")
        return
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        state, _ = trainer.train_step(state, data)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / PROFILE_STEPS
    try:
        prof.stop()
    except RuntimeError as exc:
        log(f"[profile {tag}] not measured ({exc})")
        return
    # device-side events only (kernels, memcpy, memset): CPU ops also
    # carry the device time of what they launched, and user annotations
    # (Optimizer.step) span kernels already counted
    events = [(dev_us(e), e) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    events = [(us, e) for us, e in events if us > 0]
    if not events:
        log(f"[profile {tag}] not measured (no device time recorded)")
        return
    busy = sum(us for us, _ in events) / PROFILE_STEPS
    n_kernels = sum(e.count for _, e in events) / PROFILE_STEPS
    log(f"[profile {tag}] per step: device busy {busy / 1e3:.3f} ms in "
        f"{n_kernels:.0f} launches; profiled wall {wall * 1e3:.3f} ms; "
        f"device idle share {1 - busy / 1e3 / step_ms:.3f} of the "
        f"unprofiled median step ({step_ms:.3f} ms)")
    events.sort(key=lambda ue: -ue[0])
    for us, e in events[:12]:
        log(f"[profile {tag}]   {us / PROFILE_STEPS:9.1f} us/step  "
            f"x{e.count / PROFILE_STEPS:5.1f}  {e.key[:90]}")
    # the port's own kernels (namespace gsn) inside the step
    ours = [(us, e) for us, e in events if "gsn::" in e.key]
    share = sum(us for us, _ in ours) / PROFILE_STEPS / busy
    log(f"[profile {tag}] the port's kernels: {share:.4f} of device busy time")
    for us, e in ours:
        log(f"[profile {tag}]   {us / e.count:9.2f} us/launch  "
            f"x{e.count / PROFILE_STEPS:5.1f}/step  {e.key[:90]}")


def zinc_cfg(GSNConfig, d_id):
    """bench.py::zinc_cfg, the ZINC GSN-EF main path."""
    return GSNConfig(
        model_name="GSN_edge_sparse", num_layers=4, d_out=D,
        out_features=1, msg_kind="general", id_scope="global",
        bn_mlp=False, id_embedding="one_hot_encoder",
        input_node_encoder="embedding", edge_encoder="embedding",
        readout="sum", in_features=1, d_in_node_encoder=[28],
        d_in_edge_encoder=[4], d_in_id=d_id)


def kernel_counters():
    """Every kernel wrapper of the port, by name (each carries its
    ``launches`` count; B4's ``graph_broadcast`` counts its calls, whose
    forwards are also in K4's count)."""
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    from gsn_tpu_torch.ops.cuda import slab_pool as k4
    from gsn_tpu_torch.ops.cuda import slab_weighted as b58
    fns = (k12.edge_message_fwd, k12.edge_message_bwd_recv,
           k3.segment_sum_sorted, k4.segment_broadcast, k4.graph_broadcast,
           b58.weighted_gather_fwd, b58.weighted_gather_bwd,
           b6.segment_minmax_fwd, b6.segment_minmax_bwd,
           b58.dgn_fused_fwd, b58.dgn_fused_bwd)
    return {fn.__name__: fn for fn in fns}


def dgn_phases(dev, card, timed):
    """Phases 7-12 (see module docstring); returns the kernel rows of
    K5/K6 in their three instantiations."""
    from gsn_tpu_torch.data.synthetic import make_dgn_like
    from gsn_tpu_torch.graphs.batching import (iterate_batches,
                                               tight_epoch_caps)
    from gsn_tpu_torch.nn.dgn import (DGNConfig, DGNNet, build_agg_ctx,
                                      build_dgn_model, compute_avg_d)
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    from gsn_tpu_torch.ops.cuda import slab_weighted as b58
    from gsn_tpu_torch.train.loop import Trainer, TrainerConfig
    from gsn_tpu_torch.train.metrics import LOSSES

    # ---- phase 7: the DGN batch --------------------------------------------
    t0 = time.perf_counter()
    graphs = make_dgn_like(1024)
    caps = tight_epoch_caps(np.arange(len(graphs)), graphs, 1024)
    host = next(iterate_batches(graphs, 1024, caps=caps, y_shape=(),
                                y_dtype=np.float32))
    data = host.to(dev)
    N, E = data.num_node_slots, data.num_edge_slots
    e_real = data.num_real_edges
    seg = edge_segments(data)
    rp, send = seg.recv_ptr, seg.send
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    log(f"[dgn] data {time.perf_counter() - t0:.1f} s: graphs "
        f"{len(graphs)}, nodes {int(host.node_mask.sum())}/{N}, edges "
        f"{e_real}/{E}, vector field width {data.edge_eig.shape[1]}; "
        f"rows with edges: receivers {n_recv}, senders {n_send}")

    # ---- phase 8: K5/K6 against the plain versions -------------------------
    d, K = DGN_D, DGN_K
    ctx = build_agg_ctx(DGN_AGGS, data, N)
    W = ctx.W                         # the main path's own [E_real, K]
    if tuple(W.shape) != (e_real, K):
        raise AssertionError(f"weight columns {tuple(W.shape)}")
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    # node rows after relu: about half exact zeros, so maxima tie
    B = torch.relu(rnd(N, d))
    g_w, g_mm = rnd(N, K * d), rnd(N, 2 * d)

    def dB_plain(dh):
        return k3.segment_sum_sorted_plain(dh, seg.send_ptr, seg.send_perm)

    def fn_grads(fn, leaves, cots):
        leaves = [x.clone().requires_grad_(True) for x in leaves]
        outs = fn(*leaves)
        return torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(outs, cots)), leaves)

    errs = {}
    # B5 weighted_gather
    out_p = b58.weighted_gather_fwd_plain(B, W, rp, send)
    errs["weighted_gather_fwd"] = max_err(
        b58.weighted_gather_fwd(B, W, rp, send), out_p, FWD_RTOL, FWD_ATOL,
        "weighted_gather_fwd")
    err = 0.0
    for need_dw in (False, True):
        got = b58.weighted_gather_bwd(B, W, g_w, rp, send, need_dw)
        want = b58.weighted_gather_bwd_plain(B, W, g_w, rp, send, need_dw)
        err = max(err, grad_check(got[:1 + need_dw], want[:1 + need_dw],
                                  f"weighted_gather_bwd[dW={need_dw}]"))
    dh_p, dW_p = b58.weighted_gather_bwd_plain(B, W, g_w, rp, send, True)
    err = max(err, grad_check(
        fn_grads(lambda b, w: (b58.weighted_gather(b, w, seg),),
                 [B, W], [g_w]),
        [dB_plain(dh_p), dW_p], "WeightedGather"))
    errs["weighted_gather_bwd"] = err

    # B6 segment_minmax (B7's global max and tie counts folded in)
    mm, cnt = b6.segment_minmax_fwd(B, rp, send)
    mm_p, cnt_p = b6.segment_minmax_fwd_plain(B, rp, send)
    errs["segment_minmax_fwd"] = max_err(mm, mm_p, FWD_RTOL, FWD_ATOL,
                                         "segment_minmax_fwd")
    exact(cnt, cnt_p, "segment_minmax_fwd tie counts")
    tie_share = float((cnt_p > 1).float().mean())
    dh_mm = b6.minmax_dh_plain(B, mm_p, cnt_p, g_mm, rp, send)
    err = grad_check([b6.segment_minmax_bwd(B, mm, cnt, g_mm, rp, send)],
                     [dh_mm], "segment_minmax_bwd")
    err = max(err, grad_check(
        fn_grads(lambda b: (b6.segment_minmax(b, seg),), [B], [g_mm]),
        [dB_plain(dh_mm)], "SegmentMinmax"))
    errs["segment_minmax_bwd"] = err

    # B8 dgn_fused
    out, mm, cnt = b58.dgn_fused_fwd(B, W, rp, send)
    errs["dgn_fused_fwd"] = max(
        max_err(out, out_p, FWD_RTOL, FWD_ATOL, "dgn_fused_fwd out"),
        max_err(mm, mm_p, FWD_RTOL, FWD_ATOL, "dgn_fused_fwd mm"))
    exact(cnt, cnt_p, "dgn_fused_fwd tie counts")
    err = 0.0
    for need_dw in (False, True):
        got = b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, rp, send, need_dw)
        want = b58.dgn_fused_bwd_plain(B, W, g_w, mm_p, cnt_p, g_mm, rp,
                                       send, need_dw)
        err = max(err, grad_check(got[:1 + need_dw], want[:1 + need_dw],
                                  f"dgn_fused_bwd[dW={need_dw}]"))
    err = max(err, grad_check(
        fn_grads(lambda b, w: b58.dgn_fused(b, w, seg), [B, W],
                 [g_w, g_mm]),
        [dB_plain(dh_p + dh_mm), dW_p], "DGNFused"))
    errs["dgn_fused_bwd"] = err
    log(f"[dgn] kernels agree with their plain versions: {errs}; "
        f"share of tied [max, -min] columns {tie_share:.4f}")

    # the library yardsticks: one PyTorch call each, checked against the
    # plain version.  S [N*K, N] and T [E, N*K] hold W as sparse CSR
    # matrices (rows v*K+k, and e), so S @ B is the weighted forward and
    # T @ g the weighted backward's dh; scatter_reduce gives [max, -min]
    # without the tie counts.
    recv = k12.receivers(rp)
    vk = (recv[:, None] * K + torch.arange(K, device=dev)).reshape(-1)
    S = torch.sparse_coo_tensor(
        torch.stack([vk, send.long().repeat_interleave(K)]), W.reshape(-1),
        (N * K, N)).coalesce().to_sparse_csr()
    T = torch.sparse_coo_tensor(
        torch.stack([torch.arange(e_real, device=dev).repeat_interleave(K),
                     vk]), W.reshape(-1), (e_real, N * K)
    ).coalesce().to_sparse_csr()
    hc = torch.cat([B[send.long()], -B[send.long()]], dim=1)
    idx = recv[:, None].expand_as(hc)
    zeros_2d = torch.zeros(N, 2 * d, device=dev)
    library = {
        "weighted_gather_fwd": lambda: torch.sparse.mm(S, B),
        "weighted_gather_bwd": lambda: torch.sparse.mm(
            T, g_w.view(N * K, d)),
        "segment_minmax_fwd": lambda: zeros_2d.scatter_reduce(
            0, idx, hc, "amax", include_self=False),
    }
    max_err(library["weighted_gather_fwd"]().view(N, K * d), out_p,
            FWD_RTOL, FWD_ATOL, "library weighted forward")
    max_err(library["weighted_gather_bwd"](), dh_p, FWD_RTOL, FWD_ATOL,
            "library weighted dh")
    max_err(library["segment_minmax_fwd"](), mm_p, FWD_RTOL, FWD_ATOL,
            "library scatter max")

    # bounds: B at the senders with edges, W, recv_ptr and send read
    # once; every output row written once; the backward's node-level
    # operands (g_w, mm, cnt, g_mm) at the receivers with edges, and dh
    # at every real edge.  The main path's backward takes no dW (the
    # weights do not need a gradient); its weighted-only part reads no B.
    f32 = 4
    walk = f32 * (n_send * d + N + 1 + e_real)
    kd, mm_w = K * d, 2 * d
    costs = {
        "weighted_gather_fwd": (walk + f32 * (e_real * K + N * kd),
                                2 * K * d * e_real),
        "weighted_gather_bwd": (f32 * (e_real * K + n_recv * kd + N + 1
                                       + e_real * d), 2 * K * d * e_real),
        "segment_minmax_fwd": (walk + f32 * 2 * N * mm_w, 2 * d * e_real),
        "segment_minmax_bwd": (walk + f32 * (3 * n_recv * mm_w
                                             + e_real * d), 4 * d * e_real),
        "dgn_fused_fwd": (walk + f32 * (e_real * K + N * kd + 2 * N * mm_w),
                          (2 * K + 2) * d * e_real),
        "dgn_fused_bwd": (walk + f32 * (e_real * K + n_recv * (kd + 3 * mm_w)
                                        + e_real * d),
                          (2 * K + 4) * d * e_real),
    }
    calls = {
        "weighted_gather_fwd": (
            lambda: b58.weighted_gather_fwd(B, W, rp, send),
            lambda: b58.weighted_gather_fwd_plain(B, W, rp, send)),
        "weighted_gather_bwd": (
            lambda: b58.weighted_gather_bwd(B, W, g_w, rp, send),
            lambda: b58.weighted_gather_bwd_plain(B, W, g_w, rp, send)),
        "segment_minmax_fwd": (
            lambda: b6.segment_minmax_fwd(B, rp, send),
            lambda: b6.segment_minmax_fwd_plain(B, rp, send)),
        "segment_minmax_bwd": (
            lambda: b6.segment_minmax_bwd(B, mm, cnt, g_mm, rp, send),
            lambda: b6.minmax_dh_plain(B, mm, cnt, g_mm, rp, send)),
        "dgn_fused_fwd": (
            lambda: b58.dgn_fused_fwd(B, W, rp, send),
            lambda: b58.dgn_fused_fwd_plain(B, W, rp, send)),
        "dgn_fused_bwd": (
            lambda: b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, rp, send),
            lambda: b58.dgn_fused_bwd_plain(B, W, g_w, mm, cnt, g_mm, rp,
                                            send)),
    }
    replaces = {
        "weighted_gather_fwd": "gsn_tpu/ops/pallas/slab_weighted.py:76",
        "weighted_gather_bwd": "gsn_tpu/ops/pallas/slab_weighted.py:102",
        "segment_minmax_fwd": "gsn_tpu/ops/pallas/slab_minmax.py:119",
        "segment_minmax_bwd": "gsn_tpu/ops/pallas/slab_minmax.py:140",
        "dgn_fused_fwd": "gsn_tpu/ops/pallas/slab_weighted.py:294",
        "dgn_fused_bwd": "gsn_tpu/ops/pallas/slab_weighted.py:315",
    }
    # B7 (slab_combine_minmax_cnt) has no slabs to combine here: its
    # global max and tie count come out of the minmax forwards
    folds = {"segment_minmax_fwd": "gsn_tpu/ops/pallas/slab_combine.py:119",
             "dgn_fused_fwd": "gsn_tpu/ops/pallas/slab_combine.py:119"}
    rows = {}
    for name, (kernel, plain) in calls.items():
        t_b, by = bound(*costs[name])
        rows[name] = dict(
            source="gsn_tpu_torch/csrc/dgn_aggregate.cu",
            replaces=replaces[name], max_abs_err=errs[name], bound_ms=t_b,
            bound_by=by, **timed(kernel, plain, library.get(name)))
        if name in folds:
            rows[name]["folds"] = folds[name]
    torch.cuda.synchronize()

    # ---- phase 9: small models, card vs CPU, one per dispatch branch -------
    avg_d = compute_avg_d(graphs)
    bce = LOSSES["BCEWithLogitsLoss"]
    small = next(iterate_batches(graphs[:64], 64, y_shape=(),
                                 y_dtype=np.float32))
    counters = kernel_counters()
    branch_kernels = {"fused": ("dgn_fused_fwd", "dgn_fused_bwd"),
                      "weighted": ("weighted_gather_fwd",
                                   "weighted_gather_bwd"),
                      "minmax": ("segment_minmax_fwd", "segment_minmax_bwd")}
    for branch, aggs in DGN_BRANCHES.items():
        cfg = DGNConfig(hidden_dim=d, out_dim=d, num_layers=2,
                        aggregators=aggs, avg_d=avg_d, dropout=0.0)
        ref = build_dgn_model(cfg, torch.Generator().manual_seed(2))
        preds, grads = {}, {}
        for where in ("cpu", "cuda"):
            m = copy.deepcopy(ref).to(where).train()
            b = small.to(where)
            before = {k: counters[k].launches for k in branch_kernels[branch]}
            y_hat = m(b)
            bce(y_hat, b.y, b.graph_mask).backward()
            preds[where] = y_hat.detach().cpu()
            grads[where] = [p.grad.detach().cpu() for p in m.parameters()]
            ran = {k: counters[k].launches - n for k, n in before.items()}
            want = cfg.num_layers if where == "cuda" else 0
            if any(n != want for n in ran.values()):
                raise AssertionError(f"{branch} branch on {where}: "
                                     f"launches {ran}, expected {want} each")
        err = max(max_err(preds["cuda"], preds["cpu"], FWD_RTOL, FWD_ATOL,
                          f"DGN {branch} prediction (card vs CPU)"),
                  grad_check(grads["cuda"], grads["cpu"],
                             f"DGN {branch} gradients (card vs CPU)"))
        log(f"[dgn] {branch} branch {aggs}: model on the card vs the CPU "
            f"max abs err {err}")

    # ---- phase 10: the DGN main path (bench.py::bench_dgn) -----------------
    cfg = DGNConfig(hidden_dim=d, out_dim=d, num_layers=4,
                    aggregators=DGN_AGGS, scalers=("identity",),
                    avg_d=avg_d, dropout=0.3, readout="mean",
                    out_features=1)
    tcfg = TrainerConfig(lr=1e-3, batch_size=1024, scheduler="None",
                         loss_fn="BCEWithLogitsLoss", prediction_fn="None")
    trainer = Trainer(cfg, tcfg, graphs, model=DGNNet(cfg))
    state = trainer.init_state(seed=0)
    L = cfg.num_layers
    # K3: the node sums of build_agg_ctx, the mean readout and each
    # layer's dB; K4: the readout's backward
    per_step = {"dgn_fused_fwd": L, "dgn_fused_bwd": L,
                "segment_sum_sorted": L + 2, "segment_broadcast": 1}
    torch.cuda.reset_peak_memory_stats()
    state, losses, step_s, launches = train_steps(trainer, state, data,
                                                  STEPS, counters)
    log(f"[dgn] losses {losses}")
    log(f"[dgn] launches in {STEPS} steps: {launches}")
    expect_launches(launches, per_step, STEPS, "DGN path")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"DGN loss did not fall: {losses}")
    for name in ("dgn_fused_fwd", "dgn_fused_bwd"):
        rows[name].update(launches=launches[name], path="dgn")
    med = statistics.median(step_s[1:])
    log(f"[dgn] train step median {med * 1e3:.3f} ms over {STEPS - 1} "
        f"steps (first {step_s[0] * 1e3:.1f} ms), "
        f"{e_real / med:.4e} real edges/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")

    # ---- phase 11: the weighted-only and minmax-only paths -----------------
    for branch in ("weighted", "minmax"):
        cfg_b = dataclasses.replace(cfg, aggregators=DGN_BRANCHES[branch])
        tr = Trainer(cfg_b, tcfg, graphs, model=DGNNet(cfg_b))
        fwd, bwd = branch_kernels[branch]
        _, b_losses, b_s, b_launches = train_steps(
            tr, tr.init_state(seed=0), data, BRANCH_STEPS, counters)
        expect_launches(b_launches, {fwd: L, bwd: L,
                                     "segment_sum_sorted": L + 2,
                                     "segment_broadcast": 1},
                        BRANCH_STEPS, f"DGN {branch} path")
        for name in (fwd, bwd):
            rows[name].update(launches=b_launches[name],
                              path=f"dgn-{branch}")
        log(f"[dgn] {branch} path: losses {b_losses}, launches "
            f"{b_launches}, median step "
            f"{statistics.median(b_s[1:]) * 1e3:.3f} ms")

    # ---- phase 12 ----------------------------------------------------------
    profile_steps(trainer, state, data, med * 1e3, "dgn")
    return rows


def molhiv_cfg(GSNConfig, d_id):
    """bench.py::molhiv_cfg, the molhiv GSN-VN-AF main path."""
    return GSNConfig(
        model_name="GSN_edge_sparse_ogb", num_layers=5, d_out=MOLHIV_D,
        d_h=2 * MOLHIV_D, out_features=1, msg_kind="ogb", id_scope="local",
        vn=True, dropout_features=0.5, readout="mean",
        final_projection=[False], jk_mlp=False, id_embedding="embedding",
        d_out_id_embedding=MOLHIV_D, input_node_encoder="atom_encoder",
        edge_encoder="bond_encoder", input_vn_encoder="embedding",
        in_features=9, in_edge_features=3, d_in_id=d_id)


def molhiv_phases(dev, card, timed):
    """Phases 13-17 (see module docstring); returns B4's kernel row."""
    from gsn_tpu_torch.config import GSNConfig
    from gsn_tpu_torch.data.synthetic import make_molhiv_like
    from gsn_tpu_torch.graphs.batching import (iterate_batches,
                                               tight_epoch_caps)
    from gsn_tpu_torch.nn.models import build_model, edge_segments
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.ops.cuda import slab_pool as k4
    from gsn_tpu_torch.train.loop import Trainer, TrainerConfig
    from gsn_tpu_torch.train.metrics import LOSSES

    # ---- phase 13: the molhiv batch ----------------------------------------
    t0 = time.perf_counter()
    graphs, d_id = make_molhiv_like(1024)
    caps = tight_epoch_caps(np.arange(len(graphs)), graphs, 1024)
    host = next(iterate_batches(graphs, 1024, caps=caps, y_shape=(),
                                y_dtype=np.float32))
    data = host.to(dev)
    N, E, G = data.num_node_slots, data.num_edge_slots, data.num_graph_slots
    e_real = data.num_real_edges
    seg = edge_segments(data)
    rp, send, gp = seg.recv_ptr, seg.send, data.graph_ptr
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    g_full = int((gp.diff() > 0).sum())
    log(f"[molhiv] data {time.perf_counter() - t0:.1f} s: graphs "
        f"{len(graphs)}, nodes {int(host.node_mask.sum())}/{N}, edges "
        f"{e_real}/{E}, graph slots {G} ({g_full} with nodes), id vocab "
        f"{d_id}; rows with edges: receivers {n_recv}, senders {n_send}")

    # ---- phase 14: B4 and the ogb form of K1/K2 ----------------------------
    d = MOLHIV_D
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    vn, g_node = rnd(G, d), rnd(N, d)
    B, Pe, b1 = rnd(N, d), rnd(E, d), torch.zeros(d, device=dev)
    out = k4.graph_broadcast(vn, gp, N)
    out_p = k4.graph_broadcast_plain(vn, gp, N)
    err = max_err(out, out_p, FWD_RTOL, FWD_ATOL, "graph_broadcast")
    if out[~data.node_mask].any():
        raise AssertionError("graph_broadcast: padding rows are not 0")
    leaves = [vn.clone().requires_grad_(True) for _ in range(2)]
    err = max(err, grad_check(
        torch.autograd.grad((k4.graph_broadcast(leaves[0], gp, N)
                             * g_node).sum(), leaves[:1]),
        torch.autograd.grad((k4.graph_broadcast_plain(leaves[1], gp, N)
                             * g_node).sum(), leaves[1:]),
        "GraphBroadcast"))
    msg_err = max_err(
        k12.edge_message_fwd(None, B, Pe, b1, rp, send),
        k12.edge_message_fwd_plain(None, B, Pe, b1, rp, send),
        FWD_RTOL, FWD_ATOL, "edge_message_fwd[ogb]")
    dH, dA = k12.edge_message_bwd_recv(None, B, Pe, b1, g_node, rp, send,
                                       "relu", E)
    dH_p, _ = k12.edge_message_bwd_recv_plain(None, B, Pe, b1, g_node, rp,
                                              send, "relu", E)
    if dA is not None:
        raise AssertionError("edge_message_bwd_recv[ogb] returned dA")
    msg_err = max(msg_err, max_err(dH, dH_p, FWD_RTOL, FWD_ATOL,
                                   "edge_message_bwd_recv[ogb] dH"))
    leaves = [t.clone().requires_grad_(True) for t in (B, Pe)]
    ref = [t.clone().requires_grad_(True) for t in (B, Pe)]
    msg_err = max(msg_err, grad_check(
        torch.autograd.grad((k12.edge_message_aggregate(
            None, *leaves, b1, seg, "relu") * g_node).sum(), leaves),
        torch.autograd.grad((k12.edge_message_fwd_plain(
            None, *ref, b1, rp, send) * g_node).sum(), ref),
        "EdgeMessageAggregate[ogb]"))
    log(f"[molhiv] at d={d}: B4 agrees with its plain version (max abs err "
        f"{err}, padding rows 0); K1/K2 in the ogb form max abs err "
        f"{msg_err}")

    # B4's yardstick: one index_select over vn with a zero row appended
    vn_ext = torch.cat([vn, torch.zeros(1, d, device=dev)])
    node_graph = torch.where(data.node_mask, data.batch.long(),
                             torch.full_like(data.batch.long(), G))
    max_err(torch.index_select(vn_ext, 0, node_graph), out_p, FWD_RTOL,
            FWD_ATOL, "library graph broadcast")
    t_b, by = bound(4 * (g_full * d + N * d + G + 1), 0)
    row = dict(source="gsn_tpu_torch/csrc/segment_broadcast.cu",
               replaces="gsn_tpu/ops/pallas/slab_pool.py:201",
               max_abs_err=err, bound_ms=t_b, bound_by=by,
               **timed(lambda: k4.graph_broadcast(vn, gp, N),
                       lambda: k4.graph_broadcast_plain(vn, gp, N),
                       lambda: torch.index_select(vn_ext, 0, node_graph)))
    # the ogb form of K1/K2 and B4's backward (K3 over graph_ptr), on
    # log lines of their own (their rows hold the zinc path's form)
    n_real = int(data.node_mask.sum())
    zeros_gd = torch.zeros(G, d, device=dev)
    batch_l = data.batch[:n_real].long()
    extra = {
        "edge_message_fwd[ogb]": (
            (lambda: k12.edge_message_fwd(None, B, Pe, b1, rp, send)),
            (lambda: k12.edge_message_fwd_plain(None, B, Pe, b1, rp, send)),
            None,
            bound(4 * ((n_send + N) * d + e_real * d + d + N + 1 + e_real),
                  3 * e_real * d)),
        "edge_message_bwd_recv[ogb]": (
            (lambda: k12.edge_message_bwd_recv(None, B, Pe, b1, g_node, rp,
                                               send, "relu", E)),
            (lambda: k12.edge_message_bwd_recv_plain(
                None, B, Pe, b1, g_node, rp, send, "relu", E)),
            None,
            bound(4 * ((n_recv + n_send) * d + e_real * d + E * d + d + N
                       + 1 + e_real), 3 * e_real * d)),
        "graph_broadcast backward (K3)": (
            (lambda: k3.segment_sum_sorted(g_node, gp)),
            (lambda: k3.segment_sum_sorted_plain(g_node, gp)),
            (lambda: torch.index_add(zeros_gd, 0, batch_l,
                                     g_node[:n_real])),
            bound(4 * (n_real * d + G * d + G + 1), n_real * d)),
    }
    for name, (kernel, plain, library, (t_x, by_x)) in extra.items():
        log(f"[molhiv] {name} "
            + " ".join(f"{k} {v}" for k, v in
                       timed(kernel, plain, library).items())
            + f" bound_ms {t_x} bound_by {by_x}")
    torch.cuda.synchronize()

    # ---- phase 15: a small GNN_OGB, card vs CPU ----------------------------
    counters = kernel_counters()
    bce = LOSSES["BCEWithLogitsLoss"]
    small_cfg = dataclasses.replace(
        molhiv_cfg(GSNConfig, d_id), num_layers=2, d_out=32, d_h=64,
        d_out_id_embedding=32, dropout_features=0.0)
    small = next(iterate_batches(graphs[:60], 64, y_shape=(),
                                 y_dtype=np.float32))
    ref_model = build_model(small_cfg, torch.Generator().manual_seed(3))
    preds, grads = {}, {}
    for where in ("cpu", "cuda"):
        m = copy.deepcopy(ref_model).to(where).train()
        b = small.to(where)
        before = {k: counters[k].launches
                  for k in ("graph_broadcast", "edge_message_fwd")}
        y_hat = m(b)
        bce(y_hat, b.y, b.graph_mask).backward()
        preds[where] = y_hat.detach().cpu()
        grads[where] = [p.grad.detach().cpu() for p in m.parameters()]
        ran = {k: counters[k].launches - n for k, n in before.items()}
        want = small_cfg.num_layers if where == "cuda" else 0
        if any(n != want for n in ran.values()):
            raise AssertionError(f"small GNN_OGB on {where}: launches "
                                 f"{ran}, expected {want} each")
    small_err = max(max_err(preds["cuda"], preds["cpu"], FWD_RTOL, FWD_ATOL,
                            "GNN_OGB prediction (card vs CPU)"),
                    grad_check(grads["cuda"], grads["cpu"],
                               "GNN_OGB gradients (card vs CPU)"))
    log(f"[molhiv] small GNN_OGB on the card vs the CPU: max abs err "
        f"{small_err}")

    # ---- phase 16: the molhiv main path (bench.py::molhiv_cfg) -------------
    cfg = molhiv_cfg(GSNConfig, d_id)
    tcfg = TrainerConfig(lr=1e-3, batch_size=1024, scheduler="None",
                         loss_fn="BCEWithLogitsLoss", prediction_fn="None")
    trainer = Trainer(cfg, tcfg, graphs)
    state = trainer.init_state(seed=0)
    L = cfg.num_layers
    # K3: each layer's dB, the L-1 VN sum pools and the mean readout, and
    # each B4 backward; K4: each B4 forward and each pool's backward
    per_step = {"edge_message_fwd": L, "edge_message_bwd_recv": L,
                "graph_broadcast": L, "segment_broadcast": 2 * L,
                "segment_sum_sorted": 3 * L}
    torch.cuda.reset_peak_memory_stats()
    state, losses, step_s, launches = train_steps(trainer, state, data,
                                                  STEPS, counters)
    log(f"[molhiv] losses {losses}")
    log(f"[molhiv] launches in {STEPS} steps: {launches}")
    expect_launches(launches, per_step, STEPS, "molhiv path")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"molhiv loss did not fall: {losses}")
    row.update(launches=launches["graph_broadcast"], path="molhiv")
    med = statistics.median(step_s[1:])
    log(f"[molhiv] train step median {med * 1e3:.3f} ms over {STEPS - 1} "
        f"steps (first {step_s[0] * 1e3:.1f} ms), "
        f"{e_real / med:.4e} real edges/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")

    # ---- phase 17 ----------------------------------------------------------
    profile_steps(trainer, state, data, med * 1e3, "molhiv")
    return {"graph_broadcast": row}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gsn_tpu_torch.config import GSNConfig
    from gsn_tpu_torch.data.synthetic import make_zinc_like
    from gsn_tpu_torch.graphs.batching import (iterate_batches,
                                               tight_epoch_caps)
    from gsn_tpu_torch.nn.models import build_model, edge_segments
    from gsn_tpu_torch.ops.cuda import build
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.ops.cuda import slab_pool as k4
    from gsn_tpu_torch.train.loop import (Trainer, TrainerConfig,
                                          full_f32_matmuls)
    from gsn_tpu_torch.train.metrics import l1_loss

    dev = torch.device("cuda")
    # ---- phase 1: card, precision, build ---------------------------------
    card = card_line()
    log(f"[smoke] card: {card}")
    full_f32_matmuls()
    secs = build.build_all()
    log(f"[smoke] built {len(build.SIGNATURES)} kernel libraries in "
        f"{secs:.1f} s")
    for name, text in build.build_logs.items():
        print(f"[nvcc {name}]\n{text}", file=sys.stderr)

    # ---- phase 2: the main path's batch ----------------------------------
    t0 = time.perf_counter()
    graphs, d_id = make_zinc_like(1024)
    caps = tight_epoch_caps(np.arange(len(graphs)), graphs, 1024)
    host_batch = next(iterate_batches(graphs, 1024, caps=caps, y_shape=(),
                                      y_dtype=np.float32))
    data = host_batch.to(dev)
    N, E, G = (data.num_node_slots, data.num_edge_slots,
               data.num_graph_slots)
    e_real = data.num_real_edges
    n_real = int(host_batch.node_mask.sum())
    log(f"[smoke] data {time.perf_counter() - t0:.1f} s: nodes {n_real}/{N}"
        f", edges {e_real}/{E}, graphs {G}, id vocab {d_id}")

    # ---- phase 3: each kernel against its plain version ------------------
    seg = edge_segments(data)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    A, B, Pe, b1 = rnd(N, D), rnd(N, D), rnd(E, D), rnd(D)
    g_node, g_graph = rnd(N, D), rnd(G, D)
    recv_ptr, send = seg.recv_ptr, seg.send
    # rows the functions must touch: receivers and senders with at least
    # one edge, graphs with at least one node
    n_recv = int((recv_ptr.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    n_dst = seg.send_ptr.numel() - 1
    g_full = int((data.graph_ptr.diff() > 0).sum())
    log(f"[smoke] rows with edges: receivers {n_recv}, senders {n_send}; "
        f"graphs with nodes {g_full}")
    rows = {}
    cpm = spin_cycles_per_ms()

    def timed(kernel, plain, library=None):
        ms, host_ms = time_ms(kernel, cpm)
        return dict(ms=ms, host_ms=host_ms,
                    plain_ms=time_ms(plain, cpm)[0],
                    library_ms=time_ms(library, cpm)[0] if library else None)

    # K1
    err = 0.0
    for act in ("relu", "identity"):
        err = max(err, max_err(
            k12.edge_message_fwd(A, B, Pe, b1, recv_ptr, send, act),
            k12.edge_message_fwd_plain(A, B, Pe, b1, recv_ptr, send, act),
            FWD_RTOL, FWD_ATOL, f"edge_message_fwd[{act}]"))
    # read A, B, Pe, b1, recv_ptr, send; write out
    t_b, by = bound(4 * ((n_recv + n_send + N) * D + e_real * D + D
                         + N + 1 + e_real), 5 * e_real * D)
    rows["edge_message_fwd"] = dict(
        source="gsn_tpu_torch/csrc/edge_message.cu",
        replaces="gsn_tpu/ops/pallas/slab_message.py:214",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k12.edge_message_fwd(A, B, Pe, b1, recv_ptr, send,
                                             "relu"),
                lambda: k12.edge_message_fwd_plain(A, B, Pe, b1, recv_ptr,
                                                   send, "relu")))

    # K2
    err = 0.0
    for act in ("relu", "identity"):
        dH, dA = k12.edge_message_bwd_recv(A, B, Pe, b1, g_node, recv_ptr,
                                           send, act, E)
        dH_p, dA_p = k12.edge_message_bwd_recv_plain(
            A, B, Pe, b1, g_node, recv_ptr, send, act, E)
        err = max(err, max_err(dH, dH_p, FWD_RTOL, FWD_ATOL,
                               f"edge_message_bwd_recv[{act}] dH"),
                  max_err(dA, dA_p, FWD_RTOL, FWD_ATOL,
                          f"edge_message_bwd_recv[{act}] dA"))
    # read A, g, B, Pe, b1, recv_ptr, send; write dA and dH (every slot)
    t_b, by = bound(4 * ((2 * n_recv + n_send + N) * D + e_real * D
                         + E * D + D + N + 1 + e_real), 5 * e_real * D)
    rows["edge_message_bwd_recv"] = dict(
        source="gsn_tpu_torch/csrc/edge_message.cu",
        replaces="gsn_tpu/ops/pallas/slab_message.py:240",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k12.edge_message_bwd_recv(
                    A, B, Pe, b1, g_node, recv_ptr, send, "relu", E),
                lambda: k12.edge_message_bwd_recv_plain(
                    A, B, Pe, b1, g_node, recv_ptr, send, "relu", E)))

    # K3: the sender-side dB (its row in the JSON line) and the graph
    # readout (checked, and timed on a log line of its own)
    dH_real = dH[:e_real]
    err = max_err(k3.segment_sum_sorted(dH, seg.send_ptr, seg.send_perm),
                  k3.segment_sum_sorted_plain(dH, seg.send_ptr,
                                              seg.send_perm),
                  FWD_RTOL, FWD_ATOL, "segment_sum_sorted[send]")
    err = max(err, max_err(
        k3.segment_sum_sorted(A, data.graph_ptr),
        k3.segment_sum_sorted_plain(A, data.graph_ptr),
        FWD_RTOL, FWD_ATOL, "segment_sum_sorted[pool]"))
    zeros_nd = torch.zeros(N, D, device=dev)
    send_l = send.long()
    t_b, by = bound(4 * (e_real * D + n_dst * D + n_dst + 1 + e_real),
                    e_real * D)
    rows["segment_sum_sorted"] = dict(
        source="gsn_tpu_torch/csrc/segment_sum.cu",
        replaces="gsn_tpu/ops/pallas/slab_combine.py:77",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k3.segment_sum_sorted(dH, seg.send_ptr,
                                              seg.send_perm),
                lambda: k3.segment_sum_sorted_plain(dH, seg.send_ptr,
                                                    seg.send_perm),
                lambda: torch.index_add(zeros_nd, 0, send_l, dH_real)))
    zeros_gd = torch.zeros(G, D, device=dev)
    batch_l = data.batch[:n_real].long()
    pool_b, _ = bound(4 * (n_real * D + G * D + G + 1), n_real * D)
    pool = timed(lambda: k3.segment_sum_sorted(A, data.graph_ptr),
                 lambda: k3.segment_sum_sorted_plain(A, data.graph_ptr),
                 lambda: torch.index_add(zeros_gd, 0, batch_l, A[:n_real]))
    log("[smoke] segment_sum_sorted[pool] "
        + " ".join(f"{k} {v}" for k, v in pool.items())
        + f" bound_ms {pool_b}")

    # K4
    err = max_err(k4.segment_broadcast(g_graph, data.graph_ptr, N),
                  k4.segment_broadcast_plain(g_graph, data.graph_ptr, N),
                  FWD_RTOL, FWD_ATOL, "segment_broadcast")
    g_ext = torch.cat([g_graph, torch.zeros(1, D, device=dev)])
    node_graph = torch.where(data.node_mask, data.batch.long(),
                             torch.full_like(data.batch.long(), G))
    t_b, by = bound(4 * (g_full * D + N * D + G + 1), 0)
    rows["segment_broadcast"] = dict(
        source="gsn_tpu_torch/csrc/segment_broadcast.cu",
        replaces="gsn_tpu/ops/pallas/slab_pool.py:90",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k4.segment_broadcast(g_graph, data.graph_ptr, N),
                lambda: k4.segment_broadcast_plain(g_graph, data.graph_ptr,
                                                   N),
                lambda: torch.index_select(g_ext, 0, node_graph)))

    # the autograd Functions' backward passes against autograd through
    # the plain versions
    leaves = [t.clone().requires_grad_(True) for t in (A, B, Pe, b1)]
    out = k12.edge_message_aggregate(*leaves, seg, "relu")
    got = torch.autograd.grad((out * g_node).sum(), leaves)
    ref_leaves = [t.clone().requires_grad_(True) for t in (A, B, Pe, b1)]
    out_p = k12.edge_message_fwd_plain(*ref_leaves, recv_ptr, send, "relu")
    want = torch.autograd.grad((out_p * g_node).sum(), ref_leaves)
    fn_err = grad_check(got, want, "EdgeMessageAggregate")
    x = A.clone().requires_grad_(True)
    got = torch.autograd.grad((k4.add_pool(x, data.graph_ptr)
                               * g_graph).sum(), [x])
    x_p = A.clone().requires_grad_(True)
    want = torch.autograd.grad((k3.segment_sum_sorted_plain(
        x_p, data.graph_ptr) * g_graph).sum(), [x_p])
    fn_err = max(fn_err, grad_check(got, want, "AddPool"))
    log(f"[smoke] autograd backward max abs err {fn_err}")
    torch.cuda.synchronize()

    # ---- phase 4: whole model, card vs CPU, on a small batch -------------
    cfg = zinc_cfg(GSNConfig, d_id)
    small = next(iterate_batches(graphs[:64], 64, y_shape=(),
                                 y_dtype=np.float32))
    models, preds, grads = {}, {}, {}
    ref = build_model(cfg, torch.Generator().manual_seed(1))
    for where in ("cpu", "cuda"):
        m = build_model(cfg)
        m.load_state_dict(ref.state_dict())
        m = m.to(where).train()
        b = small.to(where)
        y_hat = m(b)
        l1_loss(y_hat, b.y, b.graph_mask).backward()
        preds[where] = y_hat.detach().cpu()
        grads[where] = [p.grad.detach().cpu() for p in m.parameters()]
        models[where] = m
    model_err = max_err(preds["cuda"], preds["cpu"], FWD_RTOL, FWD_ATOL,
                        "model prediction (card vs CPU)")
    model_err = max(model_err, grad_check(grads["cuda"], grads["cpu"],
                                          "model gradients (card vs CPU)"))
    log(f"[smoke] model on the card vs the CPU: max abs err {model_err}")

    # ---- phase 5: the main path --------------------------------------------
    tcfg = TrainerConfig(lr=1e-3, batch_size=1024, scheduler="None",
                         loss_fn="L1Loss", prediction_fn="L1Loss")
    trainer = Trainer(cfg, tcfg, graphs)
    state = trainer.init_state(seed=0)
    counters = kernel_counters()
    L = cfg.num_layers
    per_step = {"edge_message_fwd": L, "edge_message_bwd_recv": L,
                "segment_sum_sorted": L + (L + 1),
                "segment_broadcast": L + 1}
    state, losses, step_s, launches = train_steps(trainer, state, data,
                                                  STEPS, counters)
    log(f"[smoke] losses {losses}")
    log(f"[smoke] launches in {STEPS} steps: {launches}")
    expect_launches(launches, per_step, STEPS, "zinc path")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name in per_step:
        rows[name].update(launches=launches[name], path="zinc")
    med = statistics.median(step_s[1:])
    log(f"[smoke] train step median {med * 1e3:.3f} ms over {STEPS - 1} "
        f"steps (first {step_s[0] * 1e3:.1f} ms), "
        f"{e_real / med:.4e} real edges/s ({card})")

    profile_steps(trainer, state, data, med * 1e3, "zinc")

    rows.update(dgn_phases(dev, card, timed))
    rows.update(molhiv_phases(dev, card, timed))

    # kernel_ms and bound_us repeat ms and bound_ms in the units the
    # port's kernel table uses
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", **row, kernel_ms=row["ms"],
             bound_us=row["bound_ms"] * 1e3)
        for name, row in rows.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
