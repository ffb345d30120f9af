"""The benchmark of gsn_tpu_torch: one run of one cell on one machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
the program's outputs matched the plain reference (``correct``), the
window's train steps (``attempted``, ``failed``), the cell's end-to-end
metrics (``--trace 0``) or per-layer metrics (``--trace 1``), the
device, and each compared number beside its limit (``checks``, last;
they are also the last lines of standard error).  Exits non-zero, and
prints no result, without a CUDA card, when the program's package is
missing, or when JAX or the JAX package was loaded.  Cells, their
configurations, traffic and metrics are files found by the names in
``BENCHMARK.json``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args()

    # every cache of the run at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(HERE, "cache", sub)
    sys.path[:0] = [ROOT, os.path.join(HERE, "core")]
    import torch
    import registry
    work = next((w for w in registry.benchmark()["workloads"]
                 if w["name"] == a.workload), None)
    if work is None:
        print(f"no workload {a.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < work["chips"]:
        print(f"{a.workload} needs {work['chips']} CUDA card(s)",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    import cell
    out = cell.run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                   T_START)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
