"""The readings from which each limit is set, on the chip at a cell's
own size: per seed, the numbers of the program's sound set-up steps,
of the control (the plain reference computed in TF32, in the program's
place) and of each planted fault, each against the reference in f32.
No window runs.

    python3 benchmark/core/readings.py <cell> <faulted> <seed> [<seed> ...]

prints one JSON line per seed and side; the faults are planted on the
first ``faulted`` seeds only.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE]

import torch  # noqa: E402

import cell  # noqa: E402
import compare  # noqa: E402
from faults import FAULTS  # noqa: E402


def seed_readings(workload, seed, device, sizes=None, faults=FAULTS):
    """{side: numbers} of one seed: the program's sound steps, the
    control (on a card) and each of ``faults``."""
    config, _traffic, splits = cell.inputs(workload, seed, sizes)
    s32 = cell.seed32(seed)
    sound, init = cell.make_program(config, splits, seed, device)
    prog_ids, dims_p = sound.ids(), list(sound.dims)
    counted = compare.count_ids(config, splits, device)
    first = cell.first_steps(sound, config, splits, s32)
    out = {"sound": compare.check(config, splits, first, init, s32, device,
                                  prog_ids, dims_p, counted)}
    sound.close()
    if torch.device(device).type == "cuda":
        ids, dims = counted
        ref = compare.reference_readings(config, splits, ids, dims, init,
                                         first["masks"], s32, device,
                                         state=first)
        ctrl = compare.reference_readings(config, splits, ids, dims, init,
                                          first["masks"], s32, device,
                                          tf32=True, state=first)
        ctrl.update(masks=first["masks"], mask_rows=first["mask_rows"],
                    mask_sites=first["mask_sites"])
        if first["eval_rows"]["pred"] is None:
            # the rows the program reads back: each batch's loss
            ctrl["eval_rows"] = dict(ctrl["eval_rows"], pred=None)
        out["control_tf32"] = compare.numbers(
            ctrl, ref, init, config["check"].get("dropout"))
    for name, plant in faults.items():
        prog, _init = cell.make_program(config, splits, seed, device,
                                        prepared=sound)
        plant(prog)
        broken = cell.first_steps(prog, config, splits, s32)
        out[name] = compare.check(config, splits, broken, init, s32, device,
                                  prog_ids, dims_p, counted)
        prog.close()
    return out


def main():
    workload, faulted = sys.argv[1], int(sys.argv[2])
    seeds = [int(s) for s in sys.argv[3:]]
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        out = seed_readings(workload, seed, "cuda",
                            faults=FAULTS if k < faulted else {})
        for name, nums in out.items():
            print(json.dumps({"cell": workload, "seed": seed, "side": name,
                              "numbers": nums}), flush=True)
        print(f"[readings] seed {seed} {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
