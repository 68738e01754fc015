"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                           # everything; what a checkout must pass
    python3 chip_smoke.py --phases order_by,kernels # the ORDER BY path and the kernels
    python3 chip_smoke.py --phases kernels          # build and check the kernels only

Builds every CUDA kernel of ``repro_torch`` from the sources in this checkout
(one ``nvcc`` per source, all started together), then:

- ``order_by`` (the main path): LLM ORDER BY queries through
  ``llm_order_by_many`` and ``llm_order_by`` -> access paths -> ``ModelOracle``
  -> ``BatchScheduler`` -> ``ServeEngine(paged_kernel=True)`` at the full width
  of ``stablelm-1.6b`` with seeded random weights; judge rationales decode
  through the paged attention kernel;
- ``kernels``: each kernel against its plain PyTorch version over the CPU
  tests' sweeps and at full width, timed beside its bound, its plain version
  and, where one exists, the PyTorch call that computes the same function;
- ``ops``: ``flash_attention`` and ``decode_attention`` through
  ``repro_torch.kernels.ops``, the entry points the reference reaches them by;
- ``main``, ``llama`` (the serving path of the first slice), and ``profile``
  (not in the default run).

Fails (non-zero exit, no result line) when there is no CUDA device, when a
kernel does not build, launch or agree, when a path did not go through its
kernels, or when an ORDER BY contract breaks.  The last line of the output is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import OrderQuery, as_keys, llm_order_by, llm_order_by_many  # noqa: E402
from repro_torch.core.oracles.model_oracle import ModelOracle  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serving import BatchScheduler, ServeEngine  # noqa: E402
from repro_torch.serving.engine import PAGED_KERNEL_ATOL, PAGED_KERNEL_RTOL  # noqa: E402

# H100 SXM data sheet, operations per second by input type: the rate a kernel
# could reach at best (tensor cores for bf16), whatever units ours uses
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# flash and decode attention: the reference's own tolerances (tests/test_kernels.py)
ATT_TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
           torch.bfloat16: dict(atol=3e-2, rtol=0.0)}
# (b, h, kv, hd, bs, nb, maxb): the CPU tests' sweep
SWEEP = [(2, 4, 2, 16, 8, 9, 2), (3, 8, 2, 32, 16, 13, 3), (1, 4, 4, 16, 8, 5, 4),
         (3, 4, 2, 8, 4, 16, 3), (2, 8, 8, 16, 8, 12, 2), (5, 6, 3, 8, 16, 24, 4),
         (2, 4, 4, 64, 16, 9, 3), (2, 8, 2, 128, 16, 9, 3), (3, 4, 2, 16, 1, 40, 9),
         (2, 16, 2, 32, 5, 20, 7)]
# (b, h, kv, s, hd, window): tests/test_kernels.py's flash sweep (causal)
FLASH_SWEEP = [(2, 4, 2, 128, 64, 0), (1, 4, 4, 256, 32, 0), (2, 8, 2, 128, 64, 64),
               (1, 2, 1, 96, 64, 32), (1, 2, 2, 160, 128, 0)]
# (b, h, kv, sq, sk, hd): its prepended-KV sweep (q_offset = sk - sq)
FLASH_PREPENDED = [(2, 4, 2, 64, 192, 64), (1, 4, 4, 96, 256, 32), (1, 2, 1, 32, 96, 64)]
# (b, h, kv, s, hd, fill): its decode sweep
DECODE_SWEEP = [(2, 8, 2, 256, 64, 256), (1, 4, 4, 128, 128, 100), (2, 4, 1, 96, 64, 50)]
# full-width attention shapes: stablelm-1.6b (G 1) and llama3-8b (G 4)
FULL = {"stablelm-1.6b": dict(h=32, kv=32, hd=64), "llama3-8b": dict(h=32, kv=8, hd=128)}
FULL_ROWS, FULL_BS, FULL_NB, FULL_MAXB = 32, 16, 768, 23
DECODE_FULL = dict(b=32, s=1024, fill=600)
FLASH_MONOLITHIC = dict(b=1, sq=2048, off=0, sk=2048)
COUNTED = {"paged_attention": pa.paged_attention, "flash_attention": fa.flash_attention,
           "decode_attention": da.decode_attention}


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def reset_launches() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


# ------------------------------------------------------------------ kernels
def randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device=device, dtype=dtype)


def paged_case(seed, b, h, kv, hd, bs, nb, maxb, dtype, device, ctx=None):
    """Random pool (stale values everywhere), distinct non-dummy blocks per
    row, 0-padded tables, ragged context lengths."""
    rng = np.random.default_rng(seed)
    q, kp, vp = (randn(rng, s, dtype, device) for s in
                 ((b, h, hd), (nb, bs, kv, hd), (nb, bs, kv, hd)))
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


def check_close(got, want, dtype, what, tol=TOL) -> float:
    torch.testing.assert_close(got.float(), want.float(), msg=lambda m: f"{what}: {m}",
                               **tol[dtype])
    return max_err(got, want)


def time_ms(fn, flush, reps=15) -> float:
    """Median over ``reps`` single launches by CUDA events, the L2 cache
    overwritten before each: a caller finds its inputs cold (in the decode
    step every layer reads its own arena)."""
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


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def summary(name, source, replaces, path, shapes) -> dict:
    """One entry of the kernels line: the first full-width shape's numbers at
    the top level, every shape under ``shapes``."""
    return dict(name=name, route="cuda", source=source, replaces=replaces, path=path,
                shapes=shapes, **{k: shapes[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                            "bound_ms", "bound_by", "library_ms")})


def kernel_paged(device, flush) -> dict:
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
    say("kernels.sweep", kernel="paged_attention", shapes=len(SWEEP),
        max_abs_err_fp32=worst[torch.float32], max_abs_err_bf16=worst[torch.bfloat16],
        tol_fp32=TOL[torch.float32], tol_bf16=TOL[torch.bfloat16])

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
                       dtype=dtype_name(dtype), max_abs_err=err,
                       ms=time_ms(lambda: pa.paged_attention(*args), flush),
                       plain_ms=time_ms(lambda: pa.paged_attention_plain(*args), flush),
                       bound_ms=bound, bound_by=by, library_ms=None)
            say("kernels.full_width", kernel="paged_attention", **rec)
            shapes.append(rec)
    return summary("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
                   "src/repro/kernels/paged_attention.py:68", "order_by", shapes)


def flash_inputs(seed, b, h, kv, sq, sk, hd, dtype, device):
    rng = np.random.default_rng(seed)
    return (randn(rng, (b, h, sq, hd), dtype, device), randn(rng, (b, kv, sk, hd), dtype, device),
            randn(rng, (b, kv, sk, hd), dtype, device))


def sdpa_flash(q, k, v, *, causal, q_offset):
    """The yardstick: one PyTorch call computing the same function."""
    sq, sk = q.shape[2], k.shape[2]
    gqa = q.shape[1] != k.shape[1]
    if causal and q_offset == 0 and sq == sk:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=gqa)
    mask = fa.attention_mask(sq, sk, causal=causal, window=0, q_offset=q_offset,
                             device=q.device)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=gqa)


def kernel_flash(device, flush, cont_shapes) -> dict:
    """flash_attention against flash_attention_plain on the card: the sweep,
    the prepended-KV identity, then timings at full width."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (b, h, kv, s, hd, win) in enumerate(FLASH_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(i, b, h, kv, s, s, hd, dtype, device)
            got = fa.flash_attention(q, k, v, causal=True, window=win)
            torch.cuda.synchronize()
            err = check_close(got, fa.flash_attention_plain(q, k, v, causal=True, window=win),
                              dtype, f"flash_attention {(b, h, kv, s, hd, win)} {dtype}", ATT_TOL)
            worst[dtype] = max(worst[dtype], err)
    bitwise = True
    for i, (b, h, kv, sq, sk, hd) in enumerate(FLASH_PREPENDED):
        for dtype in (torch.float32, torch.bfloat16):
            off = sk - sq
            q_full, k, v = flash_inputs(100 + i, b, h, kv, sk, sk, hd, dtype, device)
            q = q_full[:, :, off:].contiguous()
            got = fa.flash_attention(q, k, v, causal=True, q_offset=off)
            mono = fa.flash_attention(q_full, k, v, causal=True)[:, :, off:]
            torch.cuda.synchronize()
            what = f"flash_attention prepended {(b, h, kv, sq, sk, hd)} {dtype}"
            err = check_close(got, fa.flash_attention_plain(q, k, v, causal=True, q_offset=off),
                              dtype, what, ATT_TOL)
            check_close(got, mono, dtype, what + " vs monolithic suffix", ATT_TOL)
            bitwise &= bool(torch.equal(got, mono))
            worst[dtype] = max(worst[dtype], err)
    say("kernels.sweep", kernel="flash_attention", shapes=len(FLASH_SWEEP) + len(FLASH_PREPENDED),
        max_abs_err_fp32=worst[torch.float32], max_abs_err_bf16=worst[torch.bfloat16],
        tol_fp32=ATT_TOL[torch.float32], tol_bf16=ATT_TOL[torch.bfloat16],
        prepended_equals_monolithic_suffix_bitwise=bitwise)

    shapes = []
    for arch, d in FULL.items():
        for tag, s in cont_shapes + [("monolithic causal", FLASH_MONOLITHIC)]:
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = flash_inputs(13, s["b"], d["h"], d["kv"], s["sq"], s["sk"], d["hd"],
                                       dtype, device)
                kw = dict(causal=True, q_offset=s["off"])
                got = fa.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                what = f"flash_attention {arch} {tag} {dtype}"
                err = check_close(got, fa.flash_attention_plain(q, k, v, **kw), dtype, what,
                                  ATT_TOL)
                lib = sdpa_flash(q, k, v, **kw)
                bound, by = fa.bound_ms(s["b"], d["h"], d["kv"], s["sq"], s["sk"], d["hd"],
                                        dtype, **kw)
                rec = dict(shape=f"{arch} {tag}: B{s['b']} H{d['h']} KV{d['kv']} hd{d['hd']} "
                                 f"Sq{s['sq']} q_offset{s['off']} Sk{s['sk']} causal",
                           dtype=dtype_name(dtype), max_abs_err=err,
                           ms=time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush),
                           plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                                            flush),
                           bound_ms=bound, bound_by=by,
                           library_ms=time_ms(lambda: sdpa_flash(q, k, v, **kw), flush),
                           library_max_abs_err=max_err(lib, got))
                say("kernels.full_width", kernel="flash_attention", **rec)
                shapes.append(rec)
    return summary("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:86", "kernels.ops", shapes)


def decode_inputs(seed, b, h, kv, s, hd, fill, dtype, device):
    rng = np.random.default_rng(seed)
    pos = np.where(np.arange(s) < fill, np.arange(s), -1).astype(np.int32)
    return (randn(rng, (b, h, hd), dtype, device), randn(rng, (b, s, kv, hd), dtype, device),
            randn(rng, (b, s, kv, hd), dtype, device), torch.from_numpy(pos).to(device))


def sdpa_decode(q, kc, vc, pos):
    """The yardstick: one PyTorch call on the same inputs (cache views)."""
    out = F.scaled_dot_product_attention(
        q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=(pos >= 0)[None, None, None, :], enable_gqa=q.shape[1] != kc.shape[2])
    return out[:, :, 0]


def kernel_decode(device, flush) -> dict:
    """decode_attention against decode_attention_plain on the card."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (b, h, kv, s, hd, fill) in enumerate(DECODE_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            args = decode_inputs(i, b, h, kv, s, hd, fill, dtype, device)
            got = da.decode_attention(*args)
            torch.cuda.synchronize()
            err = check_close(got, da.decode_attention_plain(*args), dtype,
                              f"decode_attention {(b, h, kv, s, hd, fill)} {dtype}", ATT_TOL)
            worst[dtype] = max(worst[dtype], err)
    # a cache with no occupied slot gives 0, as the reference's kernel does
    args = decode_inputs(9, 2, 8, 2, 96, 64, 0, torch.float32, device)
    empty = da.decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(empty, torch.zeros_like(empty)), "an empty cache did not give 0"
    say("kernels.sweep", kernel="decode_attention", shapes=len(DECODE_SWEEP),
        max_abs_err_fp32=worst[torch.float32], max_abs_err_bf16=worst[torch.bfloat16],
        tol_fp32=ATT_TOL[torch.float32], tol_bf16=ATT_TOL[torch.bfloat16],
        empty_cache_gives_zero=True)

    shapes = []
    b, s, fill = DECODE_FULL["b"], DECODE_FULL["s"], DECODE_FULL["fill"]
    for arch, d in FULL.items():
        for dtype in (torch.bfloat16, torch.float32):
            args = decode_inputs(17, b, d["h"], d["kv"], s, d["hd"], fill, dtype, device)
            got = da.decode_attention(*args)
            torch.cuda.synchronize()
            err = check_close(got, da.decode_attention_plain(*args), dtype,
                              f"decode_attention {arch} {dtype}", ATT_TOL)
            lib = sdpa_decode(*args)
            t_bytes = da.bound_ms(fill, b, d["h"], d["kv"], s, d["hd"], args[0].element_size())
            t_ops = 1e3 * 4 * d["hd"] * fill * b * d["h"] / PEAK_FLOPS[dtype]
            bound, by = max((t_bytes, "bytes"), (t_ops, "operations"))
            rec = dict(shape=f"{arch} B{b} H{d['h']} KV{d['kv']} hd{d['hd']} S{s} valid{fill}",
                       dtype=dtype_name(dtype), max_abs_err=err,
                       ms=time_ms(lambda: da.decode_attention(*args), flush),
                       plain_ms=time_ms(lambda: da.decode_attention_plain(*args), flush),
                       bound_ms=bound, bound_by=by,
                       library_ms=time_ms(lambda: sdpa_decode(*args), flush),
                       library_max_abs_err=max_err(lib, got))
            say("kernels.full_width", kernel="decode_attention", **rec)
            shapes.append(rec)
    return summary("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:58", "kernels.ops", shapes)


def phase_kernels(device, cont_shapes) -> list:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    return [kernel_paged(device, flush), kernel_flash(device, flush, cont_shapes),
            kernel_decode(device, flush)]


def phase_ops(device) -> dict:
    """Kernels 2 and 3 through the entry points the reference reaches them
    by (``kernels/ops.py``), at full-width stablelm shapes in bf16."""
    d = FULL["stablelm-1.6b"]
    q, k, v = flash_inputs(21, 4, d["h"], d["kv"], 64, 256, d["hd"], torch.bfloat16, device)
    dargs = decode_inputs(22, 4, d["h"], d["kv"], 256, d["hd"], 200, torch.bfloat16, device)
    reset_launches()                           # ---- the path starts here
    out_f = ops.flash_attention(q, k, v, causal=True, q_offset=192)
    out_d = ops.decode_attention(*dargs)
    torch.cuda.synchronize()
    launches = read_launches()                 # ---- and ends here
    assert torch.isfinite(out_f.float()).all() and torch.isfinite(out_d.float()).all()
    assert launches["flash_attention"] > 0 and launches["decode_attention"] > 0, launches
    say("ops", launches=launches)
    return launches


# ------------------------------------------------------------- ORDER BY path
PASSAGES = [
    "bmt stands for bone marrow transplant, a medical procedure",
    "the weather in paris is mild in october",
    "bone marrow transplants treat leukemia and lymphoma",
    "bmt is also a subway line in new york city",
    "a transplant replaces damaged marrow with healthy stem cells",
    "stock markets closed higher on tuesday",
    "patients undergoing bmt need immunosuppression",
    "the recipe calls for two cups of flour",
    "marrow donation is coordinated through national registries",
    "football season begins in september",
    "graft-versus-host disease is a bmt complication",
    "the museum opens at nine daily",
]
QUERY = "relevance to query: define bmt medical"
STATIC_PATHS = ("pointwise", "ext_pointwise", "quick", "ext_bubble", "ext_merge")
# one auto query judging its pilots with free-decoded rationales, one static query
QUERIES = [dict(path="auto", strategy="judge", sample_size=8, rationale=16),
           dict(path="ext_merge", rationale=0)]


def ledger_of(o) -> tuple:
    return (o.ledger.n_calls, o.ledger.input_tokens, o.ledger.output_tokens,
            list(o.ledger.records))


def query_kw(qd) -> dict:
    kw = dict(descending=True, limit=5, path=qd["path"])
    if qd["path"] == "auto":
        kw.update(strategy=qd["strategy"], sample_size=qd["sample_size"])
    return kw


def assert_no_leak(eng) -> None:
    assert eng.paged_active == 0, eng.paged_active
    lru = sum(len(e.blocks) for e in eng._prefix_lru.values() if e.blocks is not None)
    assert eng.pool.blocks_in_use == lru, (eng.pool.blocks_in_use, lru)
    eng.clear_prefix_cache()
    assert eng.pool.blocks_in_use == 0, eng.pool.blocks_in_use


def record_prefill_cont(lm, shapes: collections.Counter):
    """Count the (B, Sq, q_offset, Sk) of every ``prefill_cont`` the engine
    issues: the prepended-KV attention shapes of the path."""
    inner = lm.prefill_cont

    def counted(caches, batch, reserve=0):
        b, sq = batch["tokens"].shape
        off = caches[0].k.shape[2]
        shapes[(b, sq, off, off + sq)] += 1
        return inner(caches, batch, reserve=reserve)

    lm.prefill_cont = counted


def solo(eng, keys, qd) -> tuple:
    """One query alone on ``eng``: (result, report, ledger, stats deltas, wall)."""
    o = ModelOracle(eng, judge_rationale_tokens=qd["rationale"])
    st = eng.stats
    before = (st.calls, st.probe_rows, st.decode_tokens)
    t0 = time.perf_counter()
    res, rep = llm_order_by(keys, QUERY, o, **query_kw(qd))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = [a - b for a, b in zip((st.calls, st.probe_rows, st.decode_tokens), before)]
    return res, rep, ledger_of(o), delta, wall


def report_query(tag, qd, res, rep, delta, wall) -> None:
    say(f"order_by.{tag}", path=qd["path"], chosen=rep.chosen.label if rep else None,
        n_calls=res.n_calls, cost=res.cost, submissions=delta[0], probe_rows=delta[1],
        decode_tokens=delta[2], wall_seconds=wall, order=res.uids())


def phase_order_by(device, card, seed) -> tuple:
    """The main path: stablelm-1.6b at full width, bf16, seeded random
    weights, ``ServeEngine(paged_kernel=True)``."""
    cfg = get_config("stablelm-1.6b")
    lm = LM(cfg, device=device, generator=torch.Generator(device).manual_seed(seed))
    keys = as_keys(PASSAGES)
    eng = ServeEngine(lm, paged_kernel=True, max_new_tokens=16)
    cont = collections.Counter()
    record_prefill_cont(lm, cont)

    oracles = [ModelOracle(eng, judge_rationale_tokens=qd["rationale"]) for qd in QUERIES]
    queries = [OrderQuery(keys, QUERY, o, **query_kw(qd)) for qd, o in zip(QUERIES, oracles)]
    st = eng.stats
    before = (st.calls, st.probe_rows, st.decode_tokens)
    reset_launches()                           # ---- the main path starts here
    t0 = time.perf_counter()
    results = llm_order_by_many(queries, scheduler=BatchScheduler(eng))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                 # ---- and ends here
    delta = [a - b for a, b in zip((st.calls, st.probe_rows, st.decode_tokens), before)]
    assert launches["paged_attention"] > 0, launches
    assert_no_leak(eng)
    say("order_by.many", queries=len(queries), submissions=delta[0], probe_rows=delta[1],
        decode_tokens=delta[2], wall_seconds=wall, launches=launches,
        prefill_cont_shapes=[dict(b=b, sq=sq, q_offset=off, sk=sk, count=n)
                             for (b, sq, off, sk), n in cont.most_common()])
    for qd, q, res in zip(QUERIES, queries, results):
        assert len(res.order) == 5 and len(set(res.uids())) == 5, res.uids()
        say("order_by.many.query", path=qd["path"],
            chosen=q.report.chosen.label if q.report else None,
            reason=q.report.reason if q.report else None, n_calls=res.n_calls,
            cost=res.cost, order=res.uids())

    # each query of the shared call equals its solo run: order and ledger
    solo_orders = []
    for qd, q, o, res in zip(QUERIES, queries, oracles, results):
        sres, srep, sledger, sdelta, swall = solo(eng, keys, qd)
        report_query("solo", qd, sres, srep, sdelta, swall)
        assert sres.uids() == res.uids(), (qd["path"], sres.uids(), res.uids())
        assert sledger == ledger_of(o), f"{qd['path']}: ledger differs from its solo run"
        solo_orders.append(sres.uids())
        assert_no_leak(eng)
    say("order_by.many_equals_solo", orders=True, ledgers=True)

    # every static path once through llm_order_by
    for path in STATIC_PATHS:
        qd = dict(path=path, rationale=0)
        res, rep, _, delta, wall = solo(eng, keys, qd)
        assert len(res.order) == 5 and len(set(res.uids())) == 5, res.uids()
        report_query("static", qd, res, rep, delta, wall)
        assert_no_leak(eng)
    say("order_by.serve", card=card, arch=cfg.name, dtype=cfg.dtype,
        layers=cfg.decoder_layers(), stats=dict(vars(eng.stats)),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng

    # the "check" engine: kernel and dense decode side by side, the
    # tolerance asserted inline at every step of the judge's rationales
    check = ServeEngine(lm, paged_kernel="check", max_new_tokens=16)
    cres, _, _, cdelta, _ = solo(check, keys, QUERIES[0])
    assert cdelta[2] > 0, "the check engine decoded no token"
    assert_no_leak(check)
    del check
    # reported, not asserted: the dense engine's orders
    dense = ServeEngine(lm, paged_kernel=False, max_new_tokens=16)
    dense_orders = [solo(dense, keys, qd)[0].uids() for qd in QUERIES]
    assert_no_leak(dense)
    del dense
    say("order_by.check", rtol=PAGED_KERNEL_RTOL, atol=PAGED_KERNEL_ATOL, passed=True,
        decode_tokens=cdelta[2], order_equals_kernel_engine=cres.uids() == solo_orders[0],
        dense_orders_equal={qd["path"]: a == b for qd, a, b in
                            zip(QUERIES, dense_orders, solo_orders)})
    del lm.prefill_cont                        # the shim goes
    picked = [("order_by prefill_cont, most frequent", cont.most_common(1)[0][0]),
              ("order_by prefill_cont, most work", max(cont, key=lambda s: s[0] * s[1] * s[3]))]
    cont_shapes = [(tag, dict(b=b, sq=sq, off=off, sk=sk)) for tag, (b, sq, off, sk) in picked]
    return launches, cont_shapes


# ------------------------------------------------------- serving path (PR 11)
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
    Returns the kernels' launch counts over the kernel engine's work."""
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
    reset_launches()                           # ---- the path starts here
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
    launches = read_launches()                 # ---- and ends here
    n_steps = steps["kernel"]
    assert launches["paged_attention"] == n_steps * n_layers > 0, (launches, steps)
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
    warm_steps = (pa.paged_attention.launches - launches["paged_attention"]) // n_layers
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
    solo_runs = [dense.generate_lockstep([p], max_new_per=[n])[0]
                 for p, n in zip(GEN_PROMPTS, GEN_LIMITS)]
    assert outs_check == dense.generate(GEN_PROMPTS[:6], max_new_per=[6] * 6)
    del dense
    agree = dict(kernel_vs_dense=agreement(outs, outs_dense),
                 kernel_vs_solo_lockstep=agreement(outs, solo_runs),
                 dense_vs_solo_lockstep=agreement(outs_dense, solo_runs))
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
    return launches


def phase_main(device, card, seed) -> dict:
    """The first slice's serving path: stablelm-1.6b at full width, bf16,
    seeded random weights."""
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
DEFAULT_PHASES = "order_by,kernels,ops,main,llama"
FALLBACK_CONT = [("fixed (phase order_by did not run)", dict(b=32, sq=64, off=192, sk=256))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=DEFAULT_PHASES,
                    help="comma-separated subset of order_by,kernels,ops,main,llama,profile")
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
    wall = _build.build_all()
    say("build", seconds_per_source=_build.build_seconds, wall_seconds=wall,
        nvcc=_build.find_nvcc())

    launches_by_path = {}
    cont_shapes = FALLBACK_CONT
    if "order_by" in phases:
        launches_by_path["order_by"], cont_shapes = phase_order_by(device, card, args.seed)
    kernels = phase_kernels(device, cont_shapes) if "kernels" in phases else None
    if "ops" in phases:
        launches_by_path["kernels.ops"] = phase_ops(device)
    if "main" in phases:
        launches_by_path["serve"] = phase_main(device, card, args.seed)
    if "llama" in phases:
        phase_llama(device, card, args.seed)
    if "profile" in phases:
        phase_profile(device, card, args.seed)
    if kernels is not None and {"order_by", "ops"} <= phases:
        for k in kernels:
            # ``launches``: the main path's (order_by) count; each kernel must
            # have launched on the path it is reached by
            k["launches"] = launches_by_path["order_by"][k["name"]]
            k["launches_by_path"] = {p: n[k["name"]] for p, n in launches_by_path.items()}
            assert k["launches_by_path"][k["path"]] > 0, f"{k['name']} never launched"
    elif kernels is not None:
        say("note", text="phases order_by and ops did not both run: no launch counts, "
                         "so no kernels line")
        kernels = None
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
