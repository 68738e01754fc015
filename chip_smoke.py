"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                  # everything; what a checkout must pass
    python3 chip_smoke.py --phases kernels # build and check the kernels only

Builds every CUDA kernel of ``repro_torch`` from the sources in this checkout,
holds each against its plain PyTorch version on the card, then drives the
serving path (``LM`` -> ``KVBlockPool`` -> ``ServeEngine``) at the full width of
``stablelm-1.6b`` with seeded random weights, and a reduced ``llama3-8b``
through the same path.  Fails (non-zero exit, no result line) when there is no
CUDA device, when a kernel does not build, launch or agree, or when the main
path did not go through the kernels.  The last line of the output is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.serving.engine import PAGED_KERNEL_ATOL, PAGED_KERNEL_RTOL  # noqa: E402

# H100 SXM data sheet, operations per second by input type: the rate a kernel
# could reach at best (tensor cores for bf16), whatever units ours uses
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# (b, h, kv, hd, bs, nb, maxb): the CPU tests' sweep
SWEEP = [(2, 4, 2, 16, 8, 9, 2), (3, 8, 2, 32, 16, 13, 3), (1, 4, 4, 16, 8, 5, 4),
         (3, 4, 2, 8, 4, 16, 3), (2, 8, 8, 16, 8, 12, 2), (5, 6, 3, 8, 16, 24, 4),
         (2, 4, 4, 64, 16, 9, 3), (2, 8, 2, 128, 16, 9, 3), (3, 4, 2, 16, 1, 40, 9),
         (2, 16, 2, 32, 5, 20, 7)]
# full-width attention shapes: stablelm-1.6b (G 1) and llama3-8b (G 4)
FULL = {"stablelm-1.6b": dict(h=32, kv=32, hd=64), "llama3-8b": dict(h=32, kv=8, hd=128)}
FULL_ROWS, FULL_BS, FULL_NB, FULL_MAXB = 32, 16, 768, 23


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


# ------------------------------------------------------------------ kernels
def paged_case(seed, b, h, kv, hd, bs, nb, maxb, dtype, device, ctx=None):
    """Random pool (stale values everywhere), distinct non-dummy blocks per
    row, 0-padded tables, ragged context lengths."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            device=device, dtype=dtype)

    q, kp, vp = t(b, h, hd), t(nb, bs, kv, hd), t(nb, bs, kv, hd)
    ids = rng.permutation(np.arange(1, nb))[: b * maxb].reshape(b, maxb)
    if ctx is None:
        n_blk = rng.integers(1, maxb + 1, size=b)
        ctx = (n_blk - 1) * bs + rng.integers(1, bs + 1, size=b)
    ctx = np.asarray(ctx)
    n_blk = -(-ctx // bs)
    tables = np.where(np.arange(maxb)[None, :] < n_blk[:, None], ids, 0)
    return (q, kp, vp, torch.from_numpy(tables.astype(np.int32)).to(device),
            torch.from_numpy(ctx.astype(np.int32)).to(device))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(got, want, dtype, what) -> float:
    torch.testing.assert_close(got.float(), want.float(), msg=lambda m: f"{what}: {m}",
                               **TOL[dtype])
    return max_err(got, want)


def time_ms(fn, flush, reps=15) -> float:
    """Median over ``reps`` single launches by CUDA events, the L2 cache
    overwritten before each: in the decode step every layer reads its own
    arena, so a launch finds its KV cold."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(device) -> dict:
    """paged_attention against paged_attention_plain on the card."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, shape in enumerate(SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            args = paged_case(i, *shape, dtype, device)
            got = pa.paged_attention(*args)
            torch.cuda.synchronize()
            err = check_close(got, pa.paged_attention_plain(*args), dtype,
                              f"paged_attention {shape} {dtype}")
            worst[dtype] = max(worst[dtype], err)
    say("kernels.sweep", shapes=len(SWEEP), max_abs_err_fp32=worst[torch.float32],
        max_abs_err_bf16=worst[torch.bfloat16], tol_fp32=TOL[torch.float32],
        tol_bf16=TOL[torch.bfloat16])

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    rng = np.random.default_rng(7)
    ctx = rng.integers(17, FULL_MAXB * FULL_BS + 1, size=FULL_ROWS)
    ctx[0] = FULL_MAXB * FULL_BS
    shapes = []
    for arch, d in FULL.items():
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_case(11, FULL_ROWS, d["h"], d["kv"], d["hd"], FULL_BS, FULL_NB,
                              FULL_MAXB, dtype, device, ctx=ctx)
            got = pa.paged_attention(*args)
            torch.cuda.synchronize()
            err = check_close(got, pa.paged_attention_plain(*args), dtype,
                              f"paged_attention {arch} {dtype}")
            # the larger of bytes over the memory rate and the multiply-adds of
            # q.k and p.v over the valid tokens, as operations, over the peak
            t_bytes = pa.bound_ms(ctx, FULL_BS, d["h"], d["kv"], d["hd"],
                                  args[0].element_size())
            t_ops = 1e3 * int(ctx.sum()) * d["h"] * d["hd"] * 2 * 2 / PEAK_FLOPS[dtype]
            bound, by = max((t_bytes, "bytes"), (t_ops, "operations"))
            rec = dict(shape=f"{arch} B{FULL_ROWS} H{d['h']} KV{d['kv']} hd{d['hd']} "
                             f"bs{FULL_BS} ctx<= {int(ctx.max())} mean {float(ctx.mean()):.0f}",
                       dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                       ms=time_ms(lambda: pa.paged_attention(*args), flush),
                       plain_ms=time_ms(lambda: pa.paged_attention_plain(*args), flush),
                       bound_ms=bound, bound_by=by)
            say("kernels.full_width", **rec)
            shapes.append(rec)
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:68",
                launches=None, library_ms=None, shapes=shapes,
                **{k: shapes[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by")})


# ---------------------------------------------------------------- main path
CRITERIA = "relevance to a question about the history of paged memory in operating systems"
ITEMS = [f"passage {i}: " + "the quick brown fox jumps over the lazy dog " * (1 + i % 3)
         for i in range(24)]
STORY = "Summarize the following ticket for the on-call engineer.\nTicket: "
GEN_PROMPTS = (
    [(STORY, f"disk {i} on rack {i * 7} reports {i + 3} reallocated sectors") for i in range(5)]
    + ["hi", "a mid-sized prompt here", "x" * 30 + " long tail", "another one",
       "Write one line about block tables.", "Count to ten.", "q" * 100])
GEN_LIMITS = [32, 24, 16, 32, 8, 4, 32, 12, 32, 20, 28, 32]


def count_steps(engine):
    """Count the decode steps an engine takes (one model pass per step and
    implementation) without touching the kernel's own launch counter and
    without synchronising.  ``del engine._decode_paged`` removes the shim."""
    counts = {"kernel": 0, "dense": 0}
    inner = engine._decode_paged

    def counted(*a, impl):
        counts[impl] += 1
        return inner(*a, impl=impl)

    engine._decode_paged = counted
    return counts


def agreement(a, b) -> float:
    return sum(x == y for x, y in zip(a, b)) / max(len(a), 1)


def drive(lm, card, *, max_new, pool_blocks, assert_tokens: bool, tag: str) -> dict:
    """The serving path on ``lm``: a "check" engine, then the kernel engine
    (probe rounds with shared prefixes, a continuous-batching generate), then
    the dense engine and solo lockstep runs the outputs are held against.
    Returns the kernel's launch count over the kernel engine's work."""
    cfg = lm.cfg
    n_layers = cfg.decoder_layers()
    kw = dict(max_new_tokens=max_new, pool_blocks=pool_blocks, block_size=16,
              max_decode_rows=32)

    # "check": kernel and dense step side by side, tolerance asserted inline
    check = ServeEngine(lm, paged_kernel="check", **kw)
    steps = count_steps(check)
    outs_check = check.generate(GEN_PROMPTS[:6], max_new_per=[6] * 6)
    torch.cuda.synchronize()
    assert steps["kernel"] == steps["dense"] > 0, steps
    check.clear_prefix_cache()
    assert check.pool.blocks_in_use == 0
    say(f"{tag}.check", steps=steps["kernel"], rtol=PAGED_KERNEL_RTOL, atol=PAGED_KERNEL_ATOL,
        passed=True)
    del check

    eng = ServeEngine(lm, paged_kernel=True, **kw)
    steps = count_steps(eng)
    pa.paged_attention.launches = 0            # ---- the main path starts here
    pairs = [(it, ITEMS[0]) for it in ITEMS[1:]]
    t0 = time.perf_counter()
    verdicts = eng.compare_many(pairs, CRITERIA)
    scores = eng.score(ITEMS, CRITERIA)
    rescored = eng.score(ITEMS, CRITERIA)      # same regions again: cache hits
    torch.cuda.synchronize()
    t_probe = time.perf_counter() - t0
    probe_rows = eng.stats.probe_rows
    assert len(verdicts) == len(pairs) and all(v in (1, -1) for v in verdicts)
    assert len(scores) == len(ITEMS) and np.isfinite(scores).all()
    assert rescored == scores, "a cached prefix region changed a probe's logits"
    outs = eng.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS)
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches     # ---- and ends here
    n_steps = steps["kernel"]
    assert launches == n_steps * n_layers and launches > 0, (launches, steps)
    assert steps["dense"] == 0
    del eng._decode_paged                      # the rates below run unshimmed

    # the same rounds once more, now warm (libraries initialised, prefix
    # regions resident), for the smoke run's rates
    t0 = time.perf_counter()
    repeat_same = eng.compare_many(pairs, CRITERIA) == verdicts
    repeat_same &= eng.score(ITEMS, CRITERIA) == scores
    torch.cuda.synchronize()
    t_probe_warm = time.perf_counter() - t0
    probe_rows_warm = eng.stats.probe_rows - probe_rows
    before, row_steps = eng.stats.decode_tokens, eng.stats.decode_row_steps
    t0 = time.perf_counter()
    repeat_same &= eng.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS) == outs
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    decode_tokens = eng.stats.decode_tokens - before
    warm_steps = (pa.paged_attention.launches - launches) // n_layers
    rows_per_step = (eng.stats.decode_row_steps - row_steps) / warm_steps
    assert eng.stats.prefix_hits > 0, eng.stats
    assert len(outs) == len(GEN_PROMPTS) and all(isinstance(o, str) for o in outs)

    # batched probes against one-at-a-time submissions
    prompts = [eng.score_parts(t, CRITERIA) for t in ITEMS[:6]]
    batched = eng.submit_probes(prompts)
    single = np.concatenate([eng.submit_probes([p]) for p in prompts])
    assert np.isfinite(batched).all() and batched.shape == (6, cfg.vocab_size)
    probe_err = float(np.abs(batched - single).max())
    tol = 1e-4 if cfg.dtype == "float32" else PAGED_KERNEL_ATOL
    assert probe_err <= tol, (probe_err, tol)
    eng.clear_prefix_cache()
    assert eng.pool.blocks_in_use == 0, eng.pool.blocks_in_use
    stats = eng.stats
    del eng

    dense = ServeEngine(lm, paged_kernel=False, **kw)
    outs_dense = dense.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS)
    solo = [dense.generate_lockstep([p], max_new_per=[l])[0]
            for p, l in zip(GEN_PROMPTS, GEN_LIMITS)]
    assert outs_check == dense.generate(GEN_PROMPTS[:6], max_new_per=[6] * 6)
    del dense
    agree = dict(kernel_vs_dense=agreement(outs, outs_dense),
                 kernel_vs_solo_lockstep=agreement(outs, solo),
                 dense_vs_solo_lockstep=agreement(outs_dense, solo))
    if assert_tokens:
        assert outs == outs_dense, agree
    say(f"{tag}.serve", card=card, arch=cfg.name, dtype=cfg.dtype, layers=n_layers,
        decode_steps=n_steps, kernel_launches=launches,
        launches_per_decode_step=n_layers, decode_tokens=decode_tokens,
        generate_seconds=t_gen, decode_tokens_per_s=decode_tokens / t_gen,
        generate_ms_per_decode_step=1e3 * t_gen / warm_steps,
        decode_rows_per_step=rows_per_step, max_decode_rows=32,
        probe_rows_cold=probe_rows, probe_seconds_cold=t_probe,
        warm_repeat_identical=bool(repeat_same),
        probe_rows=probe_rows_warm, probe_seconds=t_probe_warm,
        probe_rows_per_s=probe_rows_warm / t_probe_warm,
        prefix_hits=stats.prefix_hits, prefix_misses=stats.prefix_misses,
        prefill_tokens=stats.prefill_tokens, probe_batched_vs_single_max_abs=probe_err,
        probe_tolerance=tol, output_agreement=agree,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return dict(launches=launches)


def phase_main(device, card, seed) -> dict:
    """stablelm-1.6b at full width, bf16, seeded random weights."""
    cfg = get_config("stablelm-1.6b")
    t0 = time.perf_counter()
    lm = LM(cfg, device=device, generator=torch.Generator(device).manual_seed(seed))
    torch.cuda.synchronize()
    say("main.model", arch=cfg.name, params=sum(p.numel() for p in lm.parameters()),
        dtype=cfg.dtype, init_seconds=time.perf_counter() - t0)
    return drive(lm, card, max_new=32, pool_blocks=768, assert_tokens=False, tag="main")


def phase_llama(device, card, seed) -> None:
    """llama3-8b reduced (GQA group of 2 in the model code) through the same
    path: bf16 as configured, and fp32 where the kernel engine's tokens must
    equal the dense engine's."""
    import dataclasses
    for dtype, strict in (("bfloat16", False), ("float32", True)):
        cfg = dataclasses.replace(get_reduced("llama3-8b"), dtype=dtype)
        lm = LM(cfg, device=device, generator=torch.Generator(device).manual_seed(seed))
        drive(lm, card, max_new=32, pool_blocks=768, assert_tokens=strict, tag=f"llama.{dtype}")


def phase_profile(device, card, seed) -> None:
    """Not part of the default run: trace one generate of the kernel engine
    at full width with torch.profiler and report the device's busy time, its
    idle share of the untraced wall time, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    lm = LM(get_config("stablelm-1.6b"), device=device,
            generator=torch.Generator(device).manual_seed(seed))
    eng = ServeEngine(lm, paged_kernel=True, max_new_tokens=32)
    eng.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS)            # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernels only: an operator's entry repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:12]
    say("profile", card=card, generate_wall_ms_untraced=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / wall_ms if busy_ms else None,
        kernels=[dict(name=e.key[:80], calls=e.count, device_ms=dev_us(e) / 1e3) for e in top])


# --------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,main,llama",
                    help="comma-separated subset of kernels,main,llama,profile")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = card_line()
    say("card", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    _build.load("paged_attention")
    say("build", seconds=_build.build_seconds, nvcc=_build.find_nvcc())

    kernels = []
    if "kernels" in phases:
        kernels.append(phase_kernels(device))
    if "main" in phases:
        run = phase_main(device, card, args.seed)
        for k in kernels:
            k["launches"] = run["launches"]
    elif kernels:
        say("note", text="phase main did not run: no launch counts, so no kernels line")
        kernels = None
    if "llama" in phases:
        phase_llama(device, card, args.seed)
    if "profile" in phases:
        phase_profile(device, card, args.seed)
    if phases >= {"kernels", "main", "llama"}:
        assert all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched"
    say("done", seconds=time.perf_counter() - t_start)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
