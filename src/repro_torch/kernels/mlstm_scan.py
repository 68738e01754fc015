"""Stabilised mLSTM recurrence: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``src/repro/kernels/mlstm_scan.py`` (``mlstm_scan``, the
Pallas TPU kernel) and of ``src/repro/kernels/ref.py`` (``mlstm_ref``, here
:func:`mlstm_scan_plain`).

Source note.  ``csrc/mlstm_scan.cu`` replaces the Pallas kernel
``repro/kernels/mlstm_scan.py::mlstm_scan``.  The function does about
``4 * dqk * dv`` operations per step and head (the memory update and its
read-out) against q, k, v, the gates and h moved once: at xLSTM's width
about 170 operations per byte, so on an H100 it is bound by bytes against
the tensor cores' bf16 rate and by operations in fp32 (:func:`bound_ms`).
One head's memory C at xLSTM's width (dqk 256 x dv 512 fp32, 512 KB) does
not fit one block, so the kernel cuts the work into (sequence * head,
64-column tile of dv), whose fp32 slice of C stays on chip for the whole
sequence; the gate sums, the scores, n and m, which every tile needs, are
recomputed in each.  bf16 runs the Pallas kernel's chunkwise form
(:func:`mlstm_chunkwise_plain`) with chunks of :data:`CHUNK` steps: its four
products (``Q K^T`` and ``Q C_prev`` as one, ``(W o S) V``,
``K^T (src o V)``) on the tensor cores (``wgmma``, bf16 in, fp32
accumulators); the operands it makes itself (the gate-weighted scores,
C's copy for the read-out and ``src o V``) are carried as two bf16 each,
the rounded value and the rounded rest, since one rounding lost 2e-2 where
a row's terms cancel; three warpgroups split h from C's update; the next
chunk arrives by TMA while one computes; persistent blocks, one an SM; a
ragged last chunk is masked.  The first design stepped through S one
position at a time with scalar FMAs and a barrier a step, and reached
0.017 of its bound.  fp32 keeps that per-step kernel: TF32 would not compute
the same function, and on fp32 FMAs the chunkwise form does more operations.

q and k are (B, H, S, dqk), v (B, H, S, dv), fp32 or bf16 alike; the gates
i, f (B, H, S) fp32; q is scaled by ``1 / sqrt(dqk)`` inside, as in the
reference.  A CUDA tensor goes to the kernel or raises; only a CPU tensor
takes the plain version.  ``mlstm_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..launch.mesh import HBM_BW, PEAK_FLOPS
from . import _build

SUPPORTED_QK_DIMS = (8, 16, 32, 64, 128, 256)
CHUNK = 64                         # steps of a chunk of the bf16 kernel (csrc kT)
LOG_FLOOR = -50.0                  # the Pallas kernel's floor on a row's stabiliser
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NEG = -1e30


def mlstm_scan_plain(q, k, v, i_g, f_g):
    """The per-step recurrence in fp32, as ``ref.mlstm_ref`` (C, n, m start
    at 0); h (B, H, S, dv) in q's dtype."""
    bsz, hh, s, dqk = q.shape
    dv = v.shape[-1]
    qs = q.float() / math.sqrt(dqk)
    kf, vf = k.float(), v.float()
    c = torch.zeros((bsz, hh, dqk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((bsz, hh, dqk), dtype=torch.float32, device=q.device)
    m = torch.zeros((bsz, hh), dtype=torch.float32, device=q.device)
    hs = []
    for t in range(s):
        lf = F.logsigmoid(f_g[:, :, t].float())
        ig = i_g[:, :, t].float()
        m2 = torch.maximum(lf + m, ig)
        decay = torch.exp(lf + m - m2)
        inj = torch.exp(ig - m2)
        c = decay[..., None, None] * c + inj[..., None, None] * (
            kf[:, :, t, :, None] * vf[:, :, t, None, :])
        n = decay[..., None] * n + inj[..., None] * kf[:, :, t]
        num = torch.einsum("bhkv,bhk->bhv", c, qs[:, :, t])
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qs[:, :, t]).abs(),
                            torch.exp(-m2))
        hs.append(num / den[..., None])
        m = m2
    return torch.stack(hs, dim=2).to(q.dtype)


def mlstm_chunkwise_plain(q, k, v, i_g, f_g, chunk: int = CHUNK):
    """The Pallas kernel's chunkwise arithmetic in fp32: S in chunks of
    ``chunk`` steps (the last may be shorter), the carry (C, n, m) passed
    from chunk to chunk, each chunk's h from matrix products stabilised per
    row, the stabiliser floored at -50.  Same result as
    :func:`mlstm_scan_plain` up to where the stabiliser is applied (the
    reference's 2e-3); the bf16 kernel computes this form.  h (B, H, S, dv)
    in q's dtype."""
    bsz, hh, s, dqk = q.shape
    dv = v.shape[-1]
    qs = q.float() / math.sqrt(dqk)
    kf, vf = k.float(), v.float()
    c = torch.zeros((bsz, hh, dqk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((bsz, hh, dqk), dtype=torch.float32, device=q.device)
    m = torch.zeros((bsz, hh), dtype=torch.float32, device=q.device)
    hs = []
    for p0 in range(0, s, chunk):
        t = min(chunk, s - p0)
        qc, kc, vc = qs[:, :, p0:p0 + t], kf[:, :, p0:p0 + t], vf[:, :, p0:p0 + t]
        ig = i_g[:, :, p0:p0 + t].float()
        bcum = torch.cumsum(F.logsigmoid(f_g[:, :, p0:p0 + t].float()), dim=-1)
        g_tot = bcum[..., -1]
        dmat = bcum[..., :, None] - bcum[..., None, :] + ig[..., None, :]
        tri = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        dmat = torch.where(tri, dmat, torch.full_like(dmat, NEG))
        inter_log = bcum + m[..., None]
        m_row = torch.maximum(dmat.amax(dim=-1), inter_log).clamp_min(LOG_FLOOR)
        w_intra = torch.exp(dmat - m_row[..., None])
        w_inter = torch.exp(inter_log - m_row)
        scores = qc @ kc.transpose(-1, -2)
        h_intra = (w_intra * scores) @ vc
        h_inter = (qc @ c) * w_inter[..., None]
        n_comb = w_intra @ kc + n[..., None, :] * w_inter[..., None]
        denom = torch.maximum((n_comb * qc).sum(-1).abs(), torch.exp(-m_row))
        hs.append((h_intra + h_inter) / denom[..., None])
        m_new = torch.maximum(g_tot + m, (g_tot[..., None] - bcum + ig).amax(dim=-1))
        src = torch.exp(g_tot[..., None] - bcum + ig - m_new[..., None])
        decay = torch.exp(g_tot + m - m_new)
        c = decay[..., None, None] * c + kc.transpose(-1, -2) @ (src[..., None] * vc)
        n = decay[..., None] * n + (kc * src[..., None]).sum(-2)
        m = m_new
    return torch.cat(hs, dim=2).to(q.dtype)


def check_args(q, k, v, i_g, f_g) -> None:
    """Raise on anything the CUDA kernel cannot take, for a tensor on any
    device.  Touches no data."""
    if q.dim() != 4 or v.dim() != 4 or i_g.dim() != 3:
        raise ValueError(f"q, k must be (B, H, S, dqk), v (B, H, S, dv), gates "
                         f"(B, H, S); got {tuple(q.shape)}, {tuple(v.shape)}, "
                         f"{tuple(i_g.shape)}")
    bsz, hh, s, dqk = q.shape
    if k.shape != q.shape or v.shape[:3] != (bsz, hh, s):
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if i_g.shape != (bsz, hh, s) or f_g.shape != (bsz, hh, s):
        raise ValueError(f"gates {tuple(i_g.shape)}, {tuple(f_g.shape)} must be "
                         f"{(bsz, hh, s)}")
    if dqk not in SUPPORTED_QK_DIMS:
        raise ValueError(f"qk head dim {dqk} not supported: the kernel is built "
                         f"for {SUPPORTED_QK_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    for name, t in (("i_g", i_g), ("f_g", f_g)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("i_g", i_g), ("f_g", f_g)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def mlstm_scan(q, k, v, i_g, f_g, *, chunk: int = 64):
    """q, k: (B, H, S, dqk); v: (B, H, S, dv); i_g, f_g: (B, H, S) ->
    h (B, H, S, dv) in q's dtype.  As in the reference, S must be a
    multiple of ``chunk``; the kernel's own chunk is :data:`CHUNK` (bf16, a
    ragged last chunk masked) or one step (fp32), whatever ``chunk`` is."""
    check_args(q, k, v, i_g, f_g)
    bsz, hh, s, dqk = q.shape
    if chunk < 1 or s % chunk:
        raise ValueError(f"S = {s} must be a multiple of chunk = {chunk}")
    if q.device.type == "cpu":
        return mlstm_scan_plain(q, k, v, i_g, f_g)
    if q.device.type != "cuda":
        raise RuntimeError(f"no mlstm_scan kernel for {q.device}")
    dv = v.shape[-1]
    out = torch.empty((bsz, hh, s, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _launcher()
    scale = 1.0 / math.sqrt(dqk)
    dv_stride = dv
    if q.dtype == torch.bfloat16:
        q, k, v, dqk, dv_stride = _chunk_layout(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_g.data_ptr(),
                f_g.data_ptr(), out.data_ptr(), bsz * hh, s, dqk, dv, dv_stride,
                _DTYPE_CODE[q.dtype], CHUNK, scale, stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_scan_launch failed with code {rc} for q "
                           f"{tuple(q.shape)} {q.dtype}, v {tuple(v.shape)}")
    mlstm_scan.launches += 1
    return out


mlstm_scan.launches = 0


def _chunk_layout(q, k, v):
    """q, k, v as the chunkwise kernel's TMA boxes read them: q and k rows of
    64, 128 or 256 values (zero columns appended below 64), v rows of a
    multiple of 8 values, each tensor 16-byte aligned.  A copy is made only
    where the caller's tensors are otherwise; xLSTM's need none.  Returns
    (q, k, v, the qk row length, the v row length)."""
    dqk, dv = q.shape[-1], v.shape[-1]
    dqk_row, dv_row = max(dqk, 64), -(-dv // 8) * 8
    if dqk_row != dqk:
        q, k = (F.pad(t, (0, dqk_row - dqk)) for t in (q, k))
    if dv_row != dv:
        v = F.pad(v, (0, dv_row - dv))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    return q, k, v, dqk_row, dv_row


def _launcher():
    fn = _build.load("mlstm_scan").mlstm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def live_bytes(bsz: int, hh: int, s: int, dqk: int, dv: int, itemsize: int) -> int:
    """Bytes the function must move: q, k, v and h in their type, the two
    fp32 gates, each once."""
    return bsz * hh * s * (itemsize * (2 * dqk + 2 * dv) + 8)


def operations(bsz: int, hh: int, s: int, dqk: int, dv: int) -> int:
    """Per step and head: the memory update and its read-out (a
    multiply-add each per element of C) and the normaliser's update and dot
    product, about ``4 dqk dv + 4 dqk``."""
    return bsz * hh * s * (4 * dqk * dv + 4 * dqk)


def bound_ms(bsz: int, hh: int, s: int, dqk: int, dv: int, dtype):
    """Least time an H100 could take: the larger of :func:`live_bytes` over
    the memory rate and :func:`operations` over the peak for the input type.
    Returns ``(ms, "bytes" | "operations")``."""
    item = torch.empty((), dtype=dtype).element_size()
    return max((1e3 * live_bytes(bsz, hh, s, dqk, dv, item) / HBM_BW, "bytes"),
               (1e3 * operations(bsz, hh, s, dqk, dv) / PEAK_FLOPS[dtype], "operations"))
