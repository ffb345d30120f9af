#!/usr/bin/env python3
"""Compare two builds of one of the port's kernels on one card.

    python3 kernel_turns.py dgn OTHER_CSRC_DIR
    python3 kernel_turns.py k4 OTHER_CSRC_DIR

Builds the kernel's source from ``OTHER_CSRC_DIR`` (another commit's
``gsn_tpu_torch/csrc``) beside this checkout's kernels:

- ``dgn``: K5/K6 (``dgn_aggregate.cu``), the six functions on them in
  the main path's forms, on the DGN batch and operands of
  ``chip_smoke.py`` phases 7-8, on f32 rows and (where both builds have
  the bf16 entry points) on bf16 rows; the path is
  ``bench.py::bench_dgn``'s configuration.
- ``k4``: K4 (``segment_broadcast.cu``) at its four shapes on the paths:
  zinc's pool backward (d=128), the DGN mean-pool backward (d=70), the
  molhiv virtual node's pool backward and B4's forward (d=300), each on
  its path's batch; the paths are the zinc and molhiv main paths.

Then:

1. For each function, checks that both builds give the same bits and
   times them with ``chip_smoke.time_ms`` in turns: other, this, this,
   other.
2. For each path, trains STEPS steps from seed 0 with each build and
   prints both loss lists.
3. For each path, profiles PROFILE_STEPS steps with each build, in turns
   other, this, this, other: device busy ms a step and the kernel's
   share of it.

Prints the card's name and power limit first and one JSON line last.
Needs one CUDA card; run from the repository root.
"""

import functools
import json
import sys

import torch

import chip_smoke as smoke

STEPS = 3
PROFILE_STEPS = 5
# mode -> (source under csrc/, the kernel's name in the log)
MODES = {"dgn": ("dgn_aggregate", "K5/K6"), "k4": ("segment_broadcast", "K4")}


def outputs(x):
    return [t for t in (x if isinstance(x, tuple) else (x,))
            if t is not None]


def busy_ms(trainer, state, data, source):
    """(device busy ms a step, ms a step of the kernels built from
    ``source``) over PROFILE_STEPS steps."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            state, _ = trainer.train_step(state, data)
        torch.cuda.synchronize()
    events = smoke.device_events(prof)
    busy = sum(us for us, _ in events)
    ours = sum(us for us, e in events if source in e.key)
    return busy / 1e3 / PROFILE_STEPS, ours / 1e3 / PROFILE_STEPS


def dgn_case(dev):
    """The dgn mode's (functions by name, paths by name: (a function
    making the path's trainer, its batch))."""
    from gsn_tpu_torch.nn.dgn import DGNNet
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    from gsn_tpu_torch.train.loop import Trainer

    graphs, _, data = smoke.dgn_batch(dev)
    seg, W, B, g_w, g_mm = smoke.dgn_operands(dev, data)
    fns = {}
    for tag, dtype in (("", torch.float32), ("[bf16]", torch.bfloat16)):
        Bt, g_wt = B.to(dtype), g_w.to(dtype)
        mm, cnt = b6.segment_minmax_fwd_plain(Bt, seg.recv_ptr, seg.send)
        fns.update({name + tag: fn for name, (fn, _) in
                    smoke.dgn_kernel_calls(Bt, W, g_wt, mm, cnt, g_mm,
                                           seg).items()})
    cfg, tcfg = smoke.dgn_main_config(graphs)
    return fns, {"dgn": (lambda: Trainer(cfg, tcfg, graphs,
                                         model=DGNNet(cfg)), data)}


def k4_case(dev):
    """The k4 mode's (functions by name, paths by name), as
    ``dgn_case``."""
    from gsn_tpu_torch.ops.cuda import slab_pool as k4
    from gsn_tpu_torch.train.loop import Trainer

    zinc = smoke.zinc_setup(dev)
    dgn_data = smoke.dgn_batch(dev)[2]
    molhiv = smoke.molhiv_setup(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def call(fn, data, d):
        g = torch.randn(data.num_graph_slots, d, device=dev, generator=gen)
        return lambda: fn(g, data.graph_ptr, data.num_node_slots)

    fns = {
        f"zinc pool backward d={smoke.D}": call(
            k4.segment_broadcast, zinc[2], smoke.D),
        f"dgn mean-pool backward d={smoke.DGN_D}": call(
            k4.segment_broadcast, dgn_data, smoke.DGN_D),
        f"molhiv pool backward d={smoke.MOLHIV_D}": call(
            k4.segment_broadcast, molhiv[2], smoke.MOLHIV_D),
        f"molhiv B4 forward d={smoke.MOLHIV_D}": call(
            k4.graph_broadcast, molhiv[2], smoke.MOLHIV_D),
    }
    return fns, {path: (functools.partial(Trainer, cfg, tcfg, graphs), data)
                 for path, (graphs, _, data, cfg, tcfg) in (("zinc", zinc),
                                                            ("molhiv", molhiv))}


def main():
    if len(sys.argv) != 3 or sys.argv[1] not in MODES:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    from gsn_tpu_torch.ops.cuda import build
    from gsn_tpu_torch.train.loop import full_f32_matmuls

    mode, other = sys.argv[1:]
    source, tag = MODES[mode]
    dev = torch.device("cuda")
    card = smoke.card_line()
    smoke.log(f"[turns] card: {card}")
    full_f32_matmuls()
    build.build_all()
    libs = {"other": build.build_other(source, other),
            "this": build.lib(source)}
    turns = ("other", "this", "this", "other")

    fns, paths = (dgn_case if mode == "dgn" else k4_case)(dev)
    cpm = smoke.spin_cycles_per_ms()
    result = {}
    for name, fn in fns.items():
        if "[bf16]" in name and not hasattr(libs["other"],
                                            "gsn_dgn_aggregate_fwd_bf16"):
            smoke.log(f"[turns] {name}: the other build has no bf16 "
                      "entry points; not turned")
            continue
        outs = {}
        for who in ("other", "this"):
            with build.use(source, libs[who]):
                outs[who] = outputs(fn())
        same = all(torch.equal(a, b) for a, b in zip(outs["other"],
                                                     outs["this"]))
        times = []
        for who in turns:
            with build.use(source, libs[who]):
                times.append((who, smoke.time_ms(fn, cpm)[0]))
        result[name] = dict(same_bits=same, turns=times)
        smoke.log(f"[turns] {name}: same bits {same}; "
                  + ", ".join(f"{who} {ms:.6f}" for who, ms in times))

    for path, (make_trainer, data) in paths.items():
        states, losses = {}, {}
        for who in ("other", "this"):
            trainer = make_trainer()
            state = trainer.init_state(seed=0)
            losses[who] = []
            with build.use(source, libs[who]):
                for _ in range(STEPS):
                    state, loss = trainer.train_step(state, data)
                    losses[who].append(float(loss))
            states[who] = (trainer, state)
            smoke.log(f"[turns] {path} {who} losses {losses[who]}")
        result[f"{path} losses"] = losses
        result[f"{path} profiles"] = []
        for who in turns:
            with build.use(source, libs[who]):
                busy, ours = busy_ms(*states[who], data, source)
            result[f"{path} profiles"].append((who, busy, ours))
            smoke.log(f"[turns] {path} {who}: device busy {busy:.3f} ms a "
                      f"step, {tag} {ours:.3f} ms")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
