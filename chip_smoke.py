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

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside the
repository, it exits nonzero before printing either.
"""

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


def profile_steps(trainer, state, data, step_ms):
    """Phase 6 (see module docstring)."""
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
        log(f"[profile] not measured ({exc})")
        return
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        state, _ = trainer.train_step(state, data)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / PROFILE_STEPS
    try:
        prof.stop()
    except RuntimeError as exc:
        log(f"[profile] not measured ({exc})")
        return
    # device-side events only (kernels, memcpy, memset): CPU ops also
    # carry the device time of what they launched, and user annotations
    # (Optimizer.step) span kernels already counted
    events = [(dev_us(e), e) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    events = [(us, e) for us, e in events if us > 0]
    if not events:
        log("[profile] not measured (no device time recorded)")
        return
    busy = sum(us for us, _ in events) / PROFILE_STEPS
    n_kernels = sum(e.count for _, e in events) / PROFILE_STEPS
    log(f"[profile] per step: device busy {busy / 1e3:.3f} ms in "
        f"{n_kernels:.0f} launches; profiled wall {wall * 1e3:.3f} ms; "
        f"device idle share {1 - busy / 1e3 / step_ms:.3f} of the "
        f"unprofiled median step ({step_ms:.3f} ms)")
    events.sort(key=lambda ue: -ue[0])
    for us, e in events[:12]:
        log(f"[profile]   {us / PROFILE_STEPS:9.1f} us/step  "
            f"x{e.count / PROFILE_STEPS:5.1f}  {e.key[:90]}")
    # the port's own kernels (namespace gsn) inside the step
    ours = [(us, e) for us, e in events if "gsn::" in e.key]
    share = sum(us for us, _ in ours) / PROFILE_STEPS / busy
    log(f"[profile] the port's kernels: {share:.4f} of device busy time")
    for us, e in ours:
        log(f"[profile]   {us / e.count:9.2f} us/launch  "
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
    kernels = {"edge_message_fwd": k12.edge_message_fwd,
               "edge_message_bwd_recv": k12.edge_message_bwd_recv,
               "segment_sum_sorted": k3.segment_sum_sorted,
               "segment_broadcast": k4.segment_broadcast}
    L = cfg.num_layers
    per_step = {"edge_message_fwd": L, "edge_message_bwd_recv": L,
                "segment_sum_sorted": L + (L + 1),
                "segment_broadcast": L + 1}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    losses, step_s = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, data)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"[smoke] losses {losses}")
    log(f"[smoke] launches in {STEPS} steps: {launches}")
    for name, n in launches.items():
        if n != per_step[name] * STEPS:
            raise AssertionError(f"{name}: {n} launches in {STEPS} steps, "
                                 f"expected {per_step[name] * STEPS}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    med = statistics.median(step_s[1:])
    log(f"[smoke] train step median {med * 1e3:.3f} ms over {STEPS - 1} "
        f"steps (first {step_s[0] * 1e3:.1f} ms), "
        f"{e_real / med:.4e} real edges/s ({card})")

    profile_steps(trainer, state, data, med * 1e3)

    # kernel_ms and bound_us repeat ms and bound_ms in the units the
    # port's kernel table uses
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", launches=launches[name], **row,
             kernel_ms=row["ms"], bound_us=row["bound_ms"] * 1e3)
        for name, row in rows.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
