"""A cell shrunk to a size the CPU runs in seconds, for the harness's tests:
the real configuration's file with its widths cut and the real mix with
fewer clients and shorter phases."""
from __future__ import annotations

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "head_dim": 16,
        "d_ff": 128, "vocab_size": 512}


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_named(name: str) -> dict:
    """A cell of ``BENCHMARK.json``, or one made from a configuration and a
    mix of ``bench/`` by its name ``<config>.<traffic>``."""
    cells = {w["name"]: w for w in spec()["workloads"]}
    if name in cells:
        return cells[name]
    config, _, traffic = name.rpartition(".")
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}


def shrink(config: dict, mix: dict, clients: int = 2) -> None:
    """Cut widths and phases."""
    m = config["model"]
    kv = 4 if m["n_kv_heads"] == m["n_heads"] else 2
    m.update(TINY, n_kv_heads=kv)
    config["engine"].update(max_probe_batch=64)
    mix.update(clients=clients, warmup_s=0.5, trace_s=0.3, drain_s=60)


def run(cell: dict, config: dict, mix: dict, seed: int = 2**31 + 77,
        seconds: float = 1.5, traced: bool = False, control: bool = False,
        **kw) -> dict:
    import torch
    from bench.harness.cell import run_cell
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))    # test workers share the CPU
    try:
        return run_cell(spec(), cell, config, mix, seed, seconds, traced, "cpu",
                        time.perf_counter(), control=control, **kw)
    finally:
        torch.set_num_threads(threads)
