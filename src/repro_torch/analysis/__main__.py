"""CLI for the invariant linter.

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch tests chip_smoke.py
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch --json report.json
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch --baseline accepted.json
    PYTHONPATH=src python -m repro_torch.analysis --rules

Exit status: 0 when every finding is baselined (or there are none),
1 when new findings exist, 2 on usage errors.  ``--write-baseline`` accepts
the current findings into the baseline file and exits 0 — use it only for
documented exceptions (see DESIGN.md "Static analysis").

Counterpart of ``src/repro/analysis/__main__.py``, scoped to the port (see
``framework.in_src``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .framework import load_baseline, run_paths, split_new, write_baseline
from .rules import ALL_RULES


def _print_catalog() -> None:
    width = max(len(r.id) for r in ALL_RULES)
    for rule in ALL_RULES:
        print(f"  {rule.id:<{width}}  {rule.summary}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant linter for the repro_torch codebase")
    parser.add_argument("paths", nargs="*",
                        help="files or directories to lint (e.g. src tests)")
    parser.add_argument("--json", metavar="FILE", default=None,
                        help="write the full findings report as JSON")
    parser.add_argument("--baseline", metavar="FILE", default=None,
                        help="JSON file of accepted findings; only NEW "
                             "findings fail the run")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept current findings into --baseline and "
                             "exit 0")
    parser.add_argument("--rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.rules:
        _print_catalog()
        return 0
    if not args.paths:
        parser.print_usage(sys.stderr)
        print("error: no paths given (try: src/repro_torch tests chip_smoke.py)",
              file=sys.stderr)
        return 2
    if args.write_baseline and not args.baseline:
        print("error: --write-baseline requires --baseline FILE",
              file=sys.stderr)
        return 2

    report = run_paths(args.paths)
    findings = report.sorted()

    baseline = []
    if args.baseline and Path(args.baseline).exists():
        baseline = load_baseline(args.baseline)
    new, accepted = split_new(findings, baseline)

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    if args.json:
        payload = {
            "files": report.files,
            "suppressed": report.suppressed,
            "baselined": len(accepted),
            "new": [f.to_dict() for f in new],
            "findings": [f.to_dict() for f in findings],
            "rules": {r.id: r.summary for r in ALL_RULES},
        }
        Path(args.json).write_text(json.dumps(payload, indent=1) + "\n")

    for f in new:
        print(str(f))
    tail = (f"{report.files} file(s), {len(new)} new finding(s), "
            f"{len(accepted)} baselined, {report.suppressed} suppressed")
    print(tail)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
