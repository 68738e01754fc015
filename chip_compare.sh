#!/usr/bin/env bash
# Times the kernels of this tree against a parent tree in one call on one
# card, in turns, so that both are read on the same card under the same load.
#
# Before the call, unpack the tree to compare against into the git-ignored
# build/ (the copy to the card takes build/ along):
#     mkdir -p build/parent && git archive <parent commit> | tar -x -C build/parent
# then, on the card, from the repository's root:
#     bash chip_compare.sh full    # parent, change, change, parent, then the
#                                  # change's --phases profile
#
# Each run's output goes to chiprun_out/compare/<tag>.log and its timed rows
# (kernels.full_width) are printed; the script exits 1 if any run failed,
# after all of them ran.  After chip_smoke.py, each run also times the rows
# the parent's chip_smoke.py lacks (moe_gating over Mixtral's 16 x 2048
# prefill), in its own tree, by its own wrapper, as time_ms does.
set -u
mode=${1:-full}
phases=${PHASES:-kernels,ops}
out=chiprun_out/compare
mkdir -p "$out"
[ "$mode" = full ] || { echo "mode must be full" >&2; exit 2; }
[ -f build/parent/chip_smoke.py ] || { echo "build/parent is missing" >&2; exit 2; }

EXTRA=$(cat <<'EOF'
import json, statistics, sys
sys.path.insert(0, "src")
import numpy as np
import torch
from repro_torch.kernels import moe_gating as mg
dev = torch.device("cuda", 0)
flush = torch.ones(256 << 20, dtype=torch.uint8, device=dev)
rng = np.random.default_rng(41)  # chip_smoke.py's GATING_PREFILL logits
lg = torch.from_numpy(rng.standard_normal((32768, 8)).astype(np.float32)).to(dev)
for _ in range(3):
    mg.moe_gating(lg, 2)
times = []
for _ in range(15):
    flush.sum(dtype=torch.int64)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    mg.moe_gating(lg, 2)
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
print(json.dumps({"phase": "kernels.full_width", "kernel": "moe_gating", "dtype": "float32",
                  "shape": "chip_compare.sh: Mixtral router, prefill 16 x 2048: T32768 E8 k2",
                  "ms": statistics.median(times)}))
EOF
)

fail=0
run() {  # run <dir> <tag> <phases>
  echo "== $2 ($1, --phases $3) $(date -u +%T)"
  (cd "$1" && python3 chip_smoke.py --phases "$3" && python3 -c "$EXTRA") > "$out/$2.log" 2>&1 \
    || { fail=1; echo "   $2 failed"; }
  grep '"kernels.full_width"' "$out/$2.log" | python3 -c '
import json, sys
for line in sys.stdin:
    r = json.loads(line)
    print("  ", r["kernel"], r.get("dtype"), r.get("shape", "")[:60], "ms", r.get("ms"),
          "bound", r.get("bound_ms"), "stream", r.get("stream_read_ms"))'
}
for r in "build/parent parent1" ". change1" ". change2" "build/parent parent2"; do
  run $r "$phases"
done
echo "== profile (., --phases profile) $(date -u +%T)"
python3 chip_smoke.py --phases profile > "$out/profile.log" 2>&1 || { fail=1; echo "   profile failed"; }
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $fail
