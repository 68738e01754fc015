"""Render the dry-run and roofline tables from dry-run JSONL.

Counterpart of ``src/repro/launch/report.py``: the same two tables, with the
mesh column from the production mesh's sizes (``32x8``, ``2x32x8``; the
reference prints its TPU pods' ``16x16``)::

    PYTHONPATH=src python -m repro_torch.launch.report dryrun.jsonl

The port has no compile step: its records carry ``count_s`` (the seconds
the dry-run took to count the step) and no ``compile_s``, which the table
shows as ``-``.
"""
from __future__ import annotations

import json
import sys

from .mesh import make_production_mesh, mesh_label


def load(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _mesh(rec: dict) -> str:
    """The record's own mesh, else the production mesh it was counted on."""
    return rec.get("mesh") or mesh_label(make_production_mesh(
        multi_pod=bool(rec.get("multi_pod"))))


def dryrun_table(recs: list[dict]) -> str:
    out = ["| arch | shape | mesh | compile_s | args/dev | temp/dev | "
           "flops/dev | AR bytes/dev | AG | A2A | CP |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        mesh = _mesh(r)
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | {mesh} | skip | "
                       f"{r['skipped'][:58]} |  |  |  |  |  |  |")
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | {mesh} | ERROR | "
                       f"{r['error'][:58]} |  |  |  |  |  |  |")
            continue
        ma = r.get("memory_analysis", {})
        ca = r.get("cost_analysis", {})
        cb = r.get("collectives", {}).get("bytes", {})
        out.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | {r.get('compile_s', '-')} "
            f"| {fmt_bytes(ma.get('argument_size_in_bytes'))} "
            f"| {fmt_bytes(ma.get('temp_size_in_bytes'))} "
            f"| {ca.get('flops', 0):.3g} "
            f"| {fmt_bytes(cb.get('all-reduce'))} "
            f"| {fmt_bytes(cb.get('all-gather'))} "
            f"| {fmt_bytes(cb.get('all-to-all'))} "
            f"| {fmt_bytes(cb.get('collective-permute'))} |")
    return "\n".join(out)


def roofline_table(recs: list[dict]) -> str:
    out = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
           "| MODEL_FLOPS | HLO_FLOPs | useful | bound_s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("multi_pod"):
            continue
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"skip: {r['skipped'][:44]} |  |  |  |  |")
            continue
        if "error" in r:
            continue
        t = r.get("roofline", {})
        out.append(
            f"| {r['arch']} | {r['shape']} | {t.get('compute_s', 0):.4g} "
            f"| {t.get('memory_s', 0):.4g} | {t.get('collective_s', 0):.4g} "
            f"| **{t.get('dominant', '?').replace('_s','')}** "
            f"| {t.get('model_flops', 0):.3g} | {t.get('hlo_flops_global', 0):.3g} "
            f"| {t.get('useful_ratio', 0):.3g} "
            f"| {t.get('step_time_bound_s', 0):.4g} |")
    return "\n".join(out)


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun.jsonl"
    recs = load(path)
    print("## Dry-run records\n")
    print(dryrun_table(recs))
    print("\n## Roofline\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
