#!/usr/bin/env bash
# Times the kernels of this tree against a parent tree in one call on one
# card, in turns, so that both are read on the same card under the same load.
#
# Before the call, unpack the tree to compare against into the git-ignored
# build/ (the copy to the card takes build/ along):
#     mkdir -p build/parent && git archive <parent commit> | tar -x -C build/parent
# then, on the card, from the repository's root:
#     bash chip_compare.sh flush   # parent, parent (reading flush), the same two again
#     bash chip_compare.sh full    # parent, parent (reading flush), change, change,
#                                  # parent (reading flush), parent, then the change's
#                                  # --phases profile
#
# "parent (reading flush)" is build/parent_rf: a copy of build/parent whose
# chip_smoke.py differs only in time_ms, which evicts L2 by reading its 256 MB
# buffer (filled once) instead of writing it, as this tree's does.  Each run's
# output goes to chiprun_out/compare/<tag>.log; the script exits 1 if any run
# failed, after all of them ran.
set -u
mode=${1:-full}
phases=${PHASES:-kernels,ops}
out=chiprun_out/compare
mkdir -p "$out"
[ -f build/parent/chip_smoke.py ] || { echo "build/parent is missing" >&2; exit 2; }

rm -rf build/parent_rf
cp -r build/parent build/parent_rf
rm -rf build/parent_rf/build
python3 - <<'EOF' || exit 2
import pathlib
p = pathlib.Path("build/parent_rf/chip_smoke.py")
s = p.read_text()
for old, new in (("        flush.zero_()\n", "        flush.sum(dtype=torch.int64)\n"),
                 ("flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)",
                  "flush = torch.ones(256 << 20, dtype=torch.uint8, device=device)")):
    assert s.count(old) == 1, f"parent's chip_smoke.py has no single {old!r}"
    s = s.replace(old, new)
p.write_text(s)
EOF

fail=0
run() {  # run <dir> <tag> <phases>
  echo "== $2 ($1, --phases $3) $(date -u +%T)"
  (cd "$1" && python3 chip_smoke.py --phases "$3") > "$out/$2.log" 2>&1 || { fail=1; echo "   $2 failed"; }
  grep '"kernels.full_width"' "$out/$2.log" | python3 -c '
import json, sys
for line in sys.stdin:
    r = json.loads(line)
    print("  ", r["kernel"], r["dtype"], r["shape"][:60], "ms", r["ms"], "bound", r["bound_ms"],
          "stream", r.get("stream_read_ms"))'
}
case $mode in
  flush)
    for r in "build/parent parent1" "build/parent_rf parent_rf1" \
             "build/parent_rf parent_rf2" "build/parent parent2"; do run $r "$phases"; done ;;
  full)
    for r in "build/parent parent1" "build/parent_rf parent_rf1" ". change1" ". change2" \
             "build/parent_rf parent_rf2" "build/parent parent2"; do run $r "$phases"; done
    run . profile profile ;;
  *) echo "mode must be flush or full" >&2; exit 2 ;;
esac
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $fail
