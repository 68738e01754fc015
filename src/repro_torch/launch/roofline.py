"""Roofline terms of one dry-run cell, from the port's own counts.

Counterpart of ``src/repro/launch/roofline.py``.  Three terms per (arch x
shape x mesh), all in seconds, on the per-card H100 figures of
``launch/mesh.py``:

  compute    = FLOPs_per_rank  / 989e12 bf16 FLOP/s
  memory     = bytes_per_rank  / 3.35e12 B/s HBM
  collective = sum over axes of that axis's result bytes per rank over the
               axis's link: NVLink 4 (450e9 B/s a direction) for ``model``,
               InfiniBand NDR (50e9 B/s) for ``data`` and ``pod``

The reference reads XLA's ``cost_analysis`` and the partitioned HLO text;
the port has neither.  Its dry-run (``launch/dryrun.py``) counts one rank's
eager program on ``meta``: FLOPs by ``torch.utils.flop_counter``'s registry,
bytes as every op's inputs and outputs (each op of an eager program reads
and writes HBM), and each collective's result bytes by kind and axis.  So
``collective_bytes_by_kind`` (an HLO parser) has no counterpart.  On ``meta``
a recurrence (the SSM and mLSTM chunk loops, the sLSTM step loop) runs one
trip (``models.layers.rolled``), as the reference's cost analysis counts a
rolled scan's body once, so the terms add
:func:`inner_scan_flop_correction`, the reference's correction for the
other trips' matmul FLOPs, to the counted FLOPs as the reference does; their
bytes and temp memory count one trip.

MODEL_FLOPS uses the 6*N*D (train) / 2*N*D (inference) convention with
N = active params (MoE: top-k experts only), D = tokens processed; the
ratio MODEL_FLOPS / counted FLOPs exposes remat recompute, attention FLOPs,
and padding/dispatch waste.
"""
from __future__ import annotations

from ..models.config import InputShape, ModelConfig
from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")


def inner_scan_flop_correction(cfg: ModelConfig, shape: InputShape) -> float:
    """GLOBAL FLOPs that XLA's cost analysis misses because they sit inside
    rolled inner recurrence scans (counted once instead of trip_count times):
    the reference's correction, matmul terms only, 3x for train cells."""
    if shape.kind == "decode":
        return 0.0  # decode has no inner scans (single-step recurrences)
    toks = shape.global_batch * shape.seq_len
    s = shape.seq_len
    t = cfg.scan_chunk
    mult = 3.0 if shape.kind == "train" else 1.0
    missing = 0.0
    for kind, n_layers in cfg.pattern:
        if kind in ("hymba_g", "hymba_l"):
            di, ns = cfg.d_inner, cfg.ssm_state
            per_tok = 2 * di * ns * 3          # assoc-scan compose + y-einsum
            n_chunks = max(s // t, 1)
            missing += n_layers * per_tok * toks * (n_chunks - 1) / n_chunks
        elif kind == "mlstm":
            h, dqk, dv = cfg.n_heads, cfg.qk, cfg.hd
            n_chunks = max(s // t, 1)
            body = (2 * h * (3 * t * t * max(dqk, dv)          # scores/intra/n
                             + 3 * t * dqk * dv)               # inter + carry
                    * shape.global_batch)
            missing += n_layers * body * (n_chunks - 1)
        elif kind == "slstm":
            h, hd = cfg.n_heads, cfg.hd
            per_step = 8 * h * hd * hd * shape.global_batch   # 4 rec matmuls
            missing += n_layers * per_step * (s - 1)
    return missing * mult


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    n_active = cfg.active_param_count()
    toks = shape.tokens_per_step
    if shape.kind == "train":
        return 6.0 * n_active * toks
    return 2.0 * n_active * toks


def roofline_terms(rec: dict, cfg: ModelConfig, shape: InputShape) -> dict:
    """The reference's keys from a dry-run record: ``cost_analysis``
    (``flops``, ``bytes accessed``: one rank's) and ``collectives``
    (``bytes_by_axis``: one rank's result bytes)."""
    chips = rec["chips"]
    ca = rec.get("cost_analysis", {})
    flops_dev = ca.get("flops", 0.0) or 0.0
    bytes_dev = ca.get("bytes accessed", 0.0) or 0.0
    by_axis = rec.get("collectives", {}).get("bytes_by_axis", {})

    correction = inner_scan_flop_correction(cfg, shape)
    counted_global = flops_dev * chips + correction
    compute_s = counted_global / (chips * PEAK_FLOPS_BF16)
    memory_s = bytes_dev / HBM_BW
    collective_s = sum(b / LINK_BW[axis] for axis, b in by_axis.items())
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=lambda k: terms[k])
    mf = model_flops(cfg, shape)
    return {
        **{k: float(f"{v:.6g}") for k, v in terms.items()},
        "dominant": dominant,
        "model_flops": float(f"{mf:.6g}"),
        "hlo_flops_global": float(f"{counted_global:.6g}"),
        "inner_scan_correction": float(f"{correction:.6g}"),
        "useful_ratio": float(f"{(mf / counted_global if counted_global else 0):.4g}"),
        "step_time_bound_s": float(f"{max(terms.values()):.6g}"),
    }
