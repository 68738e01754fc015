"""The control of the check, and the program's readings beside it.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Runs the cell's whole run once a seed, in one process (window, drain and
check as ``bench/run.py`` runs them), and reads the check's gap twice over
the same sampled rows: for the program (the lower readings the limits are
set above) and for the fp32 reference's fp8 copy put in the program's
place (every product's weight and input rounded to float8 e4m3; the upper
readings the limits are set below).  Each side is judged by the run's own
predicate and limits: ``correct`` for the program, ``control_correct`` for
the control.  Prints one JSON line a seed, and exits 1 unless on every
seed the program comes out correct and the control does not.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--warmup-s", type=float, default=None,
                    help="the mix's warm-up, shortened")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness.cell import load, run_cell
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in spec["workloads"]}[args.workload]
    config = load("configs", cell["config"])
    mix = load("mixes", cell["traffic"])
    if args.warmup_s is not None:
        mix["warmup_s"] = args.warmup_s
    separated = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = run_cell(spec, cell, config, mix, seed, args.seconds, False,
                       torch.device("cuda", 0), t0,
                       lambda *a: print("[control]", *a, file=sys.stderr, flush=True),
                       control=True)
        separated &= out["correct"] and not out["control"]["control_correct"]
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": {k: v["value"] for k, v in out["check"].items()},
                          "control": out["control"],
                          "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0 if separated else 1


if __name__ == "__main__":
    sys.exit(main())
