"""One run of one cell: set-up, the measured window, the drain, the check.

``run_cell`` takes the cell's entry of ``BENCHMARK.json``, its
configuration and mix files (found by name), the seed, the window's
seconds and whether to trace, and returns the result line.  Everything
that belongs to one configuration, one mix, one architecture or one
per-layer metric comes from its own file; nothing here names a cell or a
model's block.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from . import check, trace as trace_mod, weights as weights_mod
from .loop import ClosedLoop, Spans
from .reference import prompt_ids
from .traffic import make_table
from .yardstick import PEAK_FLOPS_BF16

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
EXACT = ("failed_queries", "readout_faults", "order_faults")


def load(kind: str, name: str, base: Path = BENCH) -> dict:
    """``<base>/<kind>/<name>.json`` (``bench/`` by default): a
    configuration or a mix, found by its name."""
    return json.loads((base / kind / f"{name}.json").read_text())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def program():
    """The program's modules the loop drives (imported here, after the
    device check, never at import of the harness)."""
    core = "repro_torch.core"
    mods = {n: importlib.import_module(f"{core}.{m}") for n, m in (
        ("types", "types"), ("executor", "executor"),
        ("access_paths", "access_paths"), ("optimizer", "optimizer.optimizer"),
        ("model_oracle", "oracles.model_oracle"))}
    mods["LM"] = importlib.import_module("repro_torch.models").LM
    mods["model_config"] = importlib.import_module("repro_torch.models.config")
    serving = importlib.import_module("repro_torch.serving")
    mods["ServeEngine"] = serving.ServeEngine
    mods["BatchScheduler"] = serving.BatchScheduler
    return SimpleNamespace(**mods)


def _by_path(kind: str, name: str, base: Path):
    """``<base>/<kind>/<name>.py`` as a module (a name may hold characters
    a module name may not, so the file is loaded by its path)."""
    path = base / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``bench/metrics/<name>.py``'s ``read``."""
    return _by_path("metrics", name, BENCH).read


def architecture(config: dict, base: Path = BENCH):
    """The model a configuration serves: ``<base>/architectures/<name>.py``
    for the file's ``"architecture"``, ``dense`` where it names none.  It
    exports ``draw``, ``program_config``, ``program_tree``, ``Reference``
    and ``prompt_flops``."""
    return _by_path("architectures", config.get("architecture", "dense"), base)


def p90(values: list) -> float:
    """90th percentile of every value (linear between order statistics)."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=10, method="inclusive")[8])


class TraceSlice:
    """A ``torch.profiler`` trace of a slice of the window, opened and
    closed between ticks, at least ``seconds`` long."""

    def __init__(self, sync, seconds: float):
        self.sync, self.seconds = sync, seconds
        self.prof = self.mark = None
        self.t_open = None
        self.closed = False

    def start(self, at: float) -> None:
        if self.prof is not None or self.closed or time.perf_counter() < at:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.mark = record_function(trace_mod.SLICE)
        self.mark.__enter__()
        self.t_open = time.perf_counter()     # starting the profiler takes seconds

    def stop(self, force: bool = False) -> None:
        if self.prof is None or self.closed:
            return
        if not (force or time.perf_counter() >= self.t_open + self.seconds):
            return
        self.sync()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.closed = True

    def read(self):
        return trace_mod.read(self.prof) if self.prof is not None else None


def run_cell(spec: dict, cell: dict, config: dict, mix: dict, seed: int,
             seconds: float, traced: bool, device, t_start: float,
             log=lambda *a: None, control: bool = False,
             base: Path = BENCH) -> dict:
    """One run; ``control`` also judges the fp8 reference put in the
    program's place by the same limits (``bench/control.py``).  The
    configuration's architecture file is found under ``base``."""
    import torch
    p = program()
    arch = architecture(config, base)
    model = config["model"]
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    # ---- set-up: weights on the device (one model a configuration, whatever
    # the seed: the seed draws the traffic), the program, the loop warmed up
    wseed = config["weights_seed"]
    weights = arch.draw(model, wseed, device)
    weights_mod.balance_readouts(arch, weights, model, weights_mod.balance_prompts(
        make_table(mix, wseed, mix["clients"], 0), wseed, mix["readouts"]))
    lm = p.LM.from_tree(arch.program_config(p.model_config, config),
                        arch.program_tree(weights))
    engine = p.ServeEngine(lm, device=device, **config["engine"])
    sched = p.BatchScheduler(engine)
    spans = Spans(annotate=traced)
    loop = ClosedLoop(p, engine, sched, mix, seed, spans)
    loop.start()
    loop.run_until(time.perf_counter() + mix["warmup_s"])
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.1f} s, {loop.next_index} queries started")

    # ---- the window: whole ticks from the first boundary on, until the
    # first boundary past ``seconds``
    stats0 = dataclasses.replace(engine.stats)
    billed0 = loop.billed()
    loop.window = loop.tracking = spans.on = True
    t0 = time.perf_counter()
    tslice = TraceSlice(sync, mix["trace_s"]) if traced else None
    while time.perf_counter() < t0 + seconds:
        if tslice is not None:
            # a quarter in, or now where the next tick would end past the
            # window (a tick longer than three quarters of it)
            tslice.start(min(t0 + 0.25 * seconds, t0 + seconds - loop.step_s))
            tslice.stop()
        loop.step()
    sync()
    t1 = time.perf_counter()
    if tslice is not None:
        tslice.stop(force=True)
    billed1 = loop.billed()
    stats1 = dataclasses.replace(engine.stats)
    loop.window = spans.on = False
    window_s = t1 - t0
    log(f"window {window_s:.1f} s, {billed1 - billed0} probes, {loop.ticks} ticks")

    # ---- the drain: the window's queries return, where the mix waits for them
    wait = mix.get("wait_for_queries", False)
    loop.drain(t1 + mix["drain_s"], wait)
    sync()
    loop.tracking = False
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # attempted: every query returned since the window opened, and those
    # submitted in it that are still out
    window_q = [q for q in loop.returned if q.in_window]
    lost = [q for q in loop.live if q.in_window] if wait else []
    attempted = len(loop.returned) + len([q for q in loop.live if q.in_window])
    errors = [q for q in loop.returned if q.error is not None]
    returned = [q for q in loop.returned if q.error is None]
    latencies = [q.t_done - q.t_submit for q in window_q if q.error is None]
    if returned:
        log(f"{len(returned)} queries returned since the window opened, "
            f"{len(latencies)} of those submitted in it; calls a query median "
            f"{statistics.median(q.n_calls for q in returned)}")
    if latencies:
        log(f"latency median {statistics.median(latencies):.2f} s, "
            f"max {max(latencies):.2f} s")
    tr = tslice.read() if tslice is not None else None
    counters = {k: getattr(stats1, k) - getattr(stats0, k)
                for k in dataclasses.asdict(stats1)}
    answered = returned + [q for q in loop.live if q.error is None]
    # what a per-layer metric's reader (bench/metrics/<name>.py) is given
    layer_input = {
        "counters": counters, "window_s": window_s, "ticks": loop.ticks,
        "operator_self_s": spans.operator_self,
        "flops": sum(arch.prompt_flops(model, len(prompt_ids(prompt)))
                     for prompt, _six in check.window_rows(answered)),
        "peak_flops": PEAK_FLOPS_BF16, "trace": tr, "model": model,
        "engine": config["engine"],
    }
    for q in loop.returned + loop.live:       # a query's oracle holds the engine
        q.oracle = q.run = q.driver = None

    # ---- the program's state is freed before the reference runs
    loop.live.clear()
    del loop, sched, engine, lm, tslice
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = {"failed_queries": len(errors) + len(lost),
               "readout_faults": check.readout_faults(answered),
               "order_faults": sum(check.order_fault(q, mix) for q in returned)}
    gaps = check.model_gaps(answered, arch, model, weights, seed,
                            mix["check"]["probe_rows"], control=control)
    limits = dict.fromkeys(EXACT, 0)
    if "probe_logit_gap" in gaps:
        numbers["probe_logit_gap"] = gaps["probe_logit_gap"]
        limits["probe_logit_gap"] = config["check_limits"]["probe_logit_gap"]

    def judged(nums: dict) -> bool:
        return (all(nums[k] <= limits[k] for k in nums) and gaps["probe_rows"] > 0
                and (not wait or bool(latencies)))

    correct = judged(numbers)
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    compared["probe_rows_compared"] = {"value": gaps["probe_rows"], "limit": 1}

    # ---- the result line
    if traced:
        metrics = {}
        for m in spec["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            value = metric_reader(m["name"])(layer_input)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s,
               "probes_per_s": (billed1 - billed0) / window_s,
               "query_p90_s": p90(latencies) if latencies else None}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]
                   if cell["name"] in m.get("workloads", [cell["name"]])}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": torch.cuda.device_count() if on_card else 1,
           "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": len(errors) + len(lost), "metrics": metrics, "device": dev}
    if traced and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": trace_mod.top(tr["ops"]),
                            "idle_gaps": trace_mod.top(tr["gaps"])}
    if control:
        # the same predicate, the control's gap in the program's place
        ctrl = dict(numbers)
        if "probe_logit_gap" in ctrl:
            ctrl["probe_logit_gap"] = gaps["control_probe_logit_gap"]
        out["control"] = {"control_probe_logit_gap": ctrl.get("probe_logit_gap"),
                          "control_correct": judged(ctrl)}
    out["check"] = compared
    return out
