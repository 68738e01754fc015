"""The benchmark of the PyTorch / CUDA port (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration is ``bench/configs/<config>.json``,
its traffic ``bench/mixes/<traffic>.json``, each per-layer metric a reader
in ``bench/metrics/<metric>.py``.  Prints progress and, last on standard
error, each number the check compared beside its limit; the last line of
standard output is the result as one JSON object.  Exits non-zero, with no
result, where CUDA is missing or has fewer devices than the cell asks for.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def log(*parts) -> None:
    print("[bench]", *parts, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = cells[args.workload]

    # caches of the program's builds stay inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness.cell import forbidden_modules, load, run_cell

    config = load("configs", cell["config"])
    mix = load("mixes", cell["traffic"])
    log(f"{cell['name']} seed {args.seed} seconds {args.seconds} trace {args.trace}"
        f" on {torch.cuda.get_device_name(0)}")
    out = run_cell(spec, cell, config, mix, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), T_START, log)
    found = forbidden_modules()
    if found:
        log(f"modules that must not load here were loaded: {found}")
        return 4
    for name, c in out["check"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
