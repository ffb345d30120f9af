#!/usr/bin/env python3
"""Compare two builds of the DGN aggregation kernels K5/K6 on one card.

    python3 dgn_turns.py OTHER_CSRC_DIR

Builds ``OTHER_CSRC_DIR/dgn_aggregate.cu`` (another commit's
``gsn_tpu_torch/csrc``) beside this checkout's kernels, then, on the
DGN batch and operands of ``chip_smoke.py`` phases 7-8:

1. For each of the six functions on K5/K6 in the main path's forms,
   checks that both builds give the same bits and times them with
   ``chip_smoke.time_ms`` in turns: other, this, this, other.
2. Trains STEPS steps of ``bench.py::bench_dgn``'s configuration from
   seed 0 with each build and prints both loss lists.
3. Profiles PROFILE_STEPS steps with each build, in turns other, this,
   this, other: device busy ms a step and the K5/K6 share of it.

Prints the card's name and power limit first and one JSON line last.
Needs one CUDA card; run from the repository root.
"""

import json
import sys

import torch

import chip_smoke as smoke

STEPS = 3
PROFILE_STEPS = 5


def outputs(x):
    return [t for t in (x if isinstance(x, tuple) else (x,))
            if t is not None]


def busy_ms(trainer, state, data):
    """(device busy ms a step, K5/K6 ms a step) over PROFILE_STEPS steps."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            state, _ = trainer.train_step(state, data)
        torch.cuda.synchronize()
    events = smoke.device_events(prof)
    busy = sum(us for us, _ in events)
    ours = sum(us for us, e in events if "dgn_aggregate" in e.key)
    return busy / 1e3 / PROFILE_STEPS, ours / 1e3 / PROFILE_STEPS


def main():
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("dgn_turns: no CUDA device", file=sys.stderr)
        return 1
    from gsn_tpu_torch.nn.dgn import DGNNet
    from gsn_tpu_torch.ops.cuda import build
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    from gsn_tpu_torch.train.loop import Trainer, full_f32_matmuls

    dev = torch.device("cuda")
    card = smoke.card_line()
    smoke.log(f"[turns] card: {card}")
    full_f32_matmuls()
    build.build_all()
    libs = {"other": build.build_other("dgn_aggregate", sys.argv[1]),
            "this": build.lib("dgn_aggregate")}
    turns = ("other", "this", "this", "other")

    graphs, _, data = smoke.dgn_batch(dev)
    seg, W, B, g_w, g_mm = smoke.dgn_operands(dev, data)
    mm, cnt = b6.segment_minmax_fwd_plain(B, seg.recv_ptr, seg.send)
    cpm = smoke.spin_cycles_per_ms()
    result = {}
    for name, (fn, _) in smoke.dgn_kernel_calls(B, W, g_w, mm, cnt, g_mm,
                                                seg).items():
        outs = {}
        for who in ("other", "this"):
            with build.use("dgn_aggregate", libs[who]):
                outs[who] = outputs(fn())
        same = all(torch.equal(a, b) for a, b in zip(outs["other"],
                                                     outs["this"]))
        times = []
        for who in turns:
            with build.use("dgn_aggregate", libs[who]):
                times.append((who, smoke.time_ms(fn, cpm)[0]))
        result[name] = dict(same_bits=same, turns=times)
        smoke.log(f"[turns] {name}: same bits {same}; "
                  + ", ".join(f"{who} {ms:.6f}" for who, ms in times))

    cfg, tcfg = smoke.dgn_main_config(graphs)
    states, losses = {}, {}
    for who in ("other", "this"):
        trainer = Trainer(cfg, tcfg, graphs, model=DGNNet(cfg))
        state = trainer.init_state(seed=0)
        losses[who] = []
        with build.use("dgn_aggregate", libs[who]):
            for _ in range(STEPS):
                state, loss = trainer.train_step(state, data)
                losses[who].append(float(loss))
        states[who] = (trainer, state)
        smoke.log(f"[turns] {who} losses {losses[who]}")
    result["losses"] = losses
    result["profiles"] = []
    for who in turns:
        with build.use("dgn_aggregate", libs[who]):
            busy, k56 = busy_ms(*states[who], data)
        result["profiles"].append((who, busy, k56))
        smoke.log(f"[turns] {who}: device busy {busy:.3f} ms a step, "
                  f"K5/K6 {k56:.3f} ms")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
