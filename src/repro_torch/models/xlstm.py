"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, sequential recurrence with block-diagonal recurrent weights).

Counterpart of ``src/repro/models/xlstm.py``.  The mLSTM sequence form is
the reference's stabilised chunkwise algorithm (an intra-chunk term shaped
like attention plus the carried inter-chunk state), a Python loop over the
chunks; :func:`mlstm_step` is the per-step recurrence.

Recurrence (per head, stabiliser m):
    m_t = max(logsig(f_t) + m_{t-1}, i_t)
    C_t = e^{logsig(f_t)+m_{t-1}-m_t} C_{t-1} + e^{i_t-m_t} k_t v_t^T
    n_t = e^{logsig(f_t)+m_{t-1}-m_t} n_{t-1} + e^{i_t-m_t} k_t
    h_t = o_t * (C_t^T q_t) / max(|n_t . q_t|, e^{-m_t})

On a mesh (``distributed.sharding.param_specs``) the projections into the
heads (mLSTM ``w_q`` / ``w_k`` / ``w_v`` / ``w_og``, sLSTM ``w_z`` /
``w_o``), ``gn_scale``, the sLSTM biases and ``w_out``'s rows are cut over
``model`` in equal parts of the flattened heads, which at 4 heads falls
inside a head; ``w_i`` / ``w_f`` and the recurrent ``r_*`` are whole.  A
process runs the recurrence of the whole heads its rows of ``w_out`` read
(``layers.head_span``), their inputs taken from the products gathered over
``model`` where they are cut; the group norm sees whole heads; the process
keeps its own columns, scales them by its ``gn_scale`` (and gates them by
its columns of ``w_og``), and its ``w_out`` product is summed over
``model``.  Its state holds those heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.context import (model_column_range, model_rank,
                                   model_row_sum)
from .layers import HeadSpan, head_span, rolled, stacked_dense_init
from .ssm import pick_chunk

NEG = -1e30


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, qk, hv) fp32
    n: torch.Tensor   # (B, H, qk) fp32
    m: torch.Tensor   # (B, H) fp32


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd) fp32
    n: torch.Tensor   # (B, H, hd) fp32
    m: torch.Tensor   # (B, H, hd) fp32
    h: torch.Tensor   # (B, H, hd) fp32


def _zeros32(n: int, *shape, device):
    return torch.zeros((n, *shape), dtype=torch.float32, device=device)


# ------------------------------------------------------------------- mLSTM
def init_mlstm_params(gen: torch.Generator, n: int, d_model: int, n_heads: int,
                      qk: int, hv: int, dtype, device) -> dict:
    def dense(d_in, d_out, scale=1.0):
        return stacked_dense_init(gen, n, d_in, d_out, dtype, device, scale)

    return {
        "w_q": dense(d_model, n_heads * qk),
        "w_k": dense(d_model, n_heads * qk),
        "w_v": dense(d_model, n_heads * hv),
        "w_i": dense(d_model, n_heads),
        "w_f": dense(d_model, n_heads),
        "w_og": dense(d_model, n_heads * hv),
        "gn_scale": _zeros32(n, n_heads * hv, device=device),
        "w_out": dense(n_heads * hv, d_model, 1.0 / math.sqrt(2.0)),
    }


def _span(p, n_heads: int, hv: int) -> HeadSpan:
    """The heads this process runs: those its rows of ``w_out`` read."""
    return head_span(n_heads, n_heads, hv, p["w_out"].shape[-2], model_rank())


def _cols(x, w, n_heads: int, dim: int, span: HeadSpan):
    """The span's heads of ``x @ w`` (heads of ``dim`` columns), flat: (...,
    span.nq * dim)."""
    return model_column_range(x @ w, n_heads * dim, span.h0 * dim, span.nq * dim)


def _mlstm_qkvif(p, x, n_heads: int, qk: int, hv: int, span=None):
    """q (pre-scaled by 1/sqrt(qk)), k (B, H, S, qk); v (B, H, S, hv) in
    x's dtype; the gates i, f (B, H, S) in fp32; H the span's heads."""
    b, s, _ = x.shape
    span = span or _span(p, n_heads, hv)
    nh = span.nq

    def heads(name, dim):
        return _cols(x, p[name], n_heads, dim, span).reshape(b, s, nh, dim).transpose(1, 2)

    q, k, v = heads("w_q", qk), heads("w_k", qk), heads("w_v", hv)
    i_g = _cols(x, p["w_i"], n_heads, 1, span).float().transpose(1, 2)
    f_g = _cols(x, p["w_f"], n_heads, 1, span).float().transpose(1, 2)
    return q / math.sqrt(qk), k, v, i_g, f_g


def _group_norm(h, scale, n_heads: int, span=None):
    """Per-head RMS norm over the value dim; h (B, S, H*hv), then the
    span's columns of it (``[col0, col0 + cols)``) times ``1 + scale``."""
    b, s, dh = h.shape
    hf = h.reshape(b, s, n_heads, dh // n_heads).float()
    var = hf.square().mean(dim=-1, keepdim=True)
    hf = (hf * torch.rsqrt(var + 1e-6)).reshape(b, s, dh)
    if span is not None and span.cols != dh:
        hf = hf.narrow(-1, span.col0, span.cols)
    return hf * (1.0 + scale)


def _out(p, h, btype, full: int):
    """``h @ w_out``, summed over ``model`` where ``w_out``'s rows are a
    cut of ``full``."""
    return model_row_sum(h.to(btype) @ p["w_out"], p["w_out"].shape[-2], full)


def mlstm_chunkwise(q, k, v, i_g, f_g, chunk: int, state: MLSTMState):
    """The stabilised chunkwise recurrence of :func:`mlstm_sequence` on its
    projections (q pre-scaled): h (B, H, S, hv) fp32 before the group norm
    and the output gate, and the final state."""
    s = q.shape[2]
    t = pick_chunk(s, chunk)
    tri = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    c_prev, n_prev, m_prev = state
    hs = []
    for c0 in range(0, s, t):
        qq, kk, vv = (a[:, :, c0:c0 + t].float() for a in (q, k, v))
        ii, ff = i_g[:, :, c0:c0 + t], f_g[:, :, c0:c0 + t]
        lf = F.logsigmoid(ff)                            # (B,H,t)
        bcum = torch.cumsum(lf, dim=-1)
        g_tot = bcum[..., -1]
        # intra-chunk log decay D[t,s] = b_t - b_s + i_s  (s <= t)
        dmat = bcum[..., :, None] - bcum[..., None, :] + ii[..., None, :]
        dmat = torch.where(tri, dmat, torch.full_like(dmat, NEG))
        inter_log = bcum + m_prev[..., None]
        m_row = torch.maximum(dmat.amax(dim=-1), inter_log)
        m_row = torch.clamp_min(m_row, -50.0)            # floor
        w_intra = torch.exp(dmat - m_row[..., None])
        w_inter = torch.exp(inter_log - m_row)
        scores = torch.einsum("bhtk,bhsk->bhts", qq, kk)
        h_intra = torch.einsum("bhts,bhsv->bhtv", w_intra * scores, vv)
        h_inter = torch.einsum("bhtk,bhkv->bhtv", qq, c_prev) * w_inter[..., None]
        n_comb = (torch.einsum("bhts,bhsk->bhtk", w_intra, kk)
                  + n_prev[:, :, None, :] * w_inter[..., None])
        denom = torch.maximum(torch.einsum("bhtk,bhtk->bht", n_comb, qq).abs(),
                              torch.exp(-m_row))
        hs.append((h_intra + h_inter) / denom[..., None])

        # chunk-end carry
        m_new = torch.maximum(g_tot + m_prev,
                              (g_tot[..., None] - bcum + ii).amax(dim=-1))
        src_w = torch.exp(g_tot[..., None] - bcum + ii - m_new[..., None])
        decay = torch.exp(g_tot + m_prev - m_new)
        c_prev = (decay[..., None, None] * c_prev
                  + torch.einsum("bhs,bhsk,bhsv->bhkv", src_w, kk, vv))
        n_prev = (decay[..., None] * n_prev
                  + torch.einsum("bhs,bhsk->bhk", src_w, kk))
        m_prev = m_new
        if rolled(q):
            hs *= s // t
            break
    return torch.cat(hs, dim=2), MLSTMState(c_prev, n_prev, m_prev)


def mlstm_sequence(p, x, n_heads: int, qk: int, hv: int, chunk: int = 128,
                   state: MLSTMState | None = None):
    """x: (B, S, D) -> (y, final MLSTMState).  Chunk snaps to a divisor of S."""
    btype = x.dtype
    b, s, _ = x.shape
    span = _span(p, n_heads, hv)
    q, k, v, i_g, f_g = _mlstm_qkvif(p, x, n_heads, qk, hv, span)
    if state is None:
        state = init_mlstm_state(b, span.nq, qk, hv, x.device)
    h, st = mlstm_chunkwise(q, k, v, i_g, f_g, chunk, state)
    h = h.transpose(1, 2).reshape(b, s, span.nq * hv)
    o = torch.sigmoid((x @ p["w_og"]).float())
    h = _group_norm(h, p["gn_scale"], span.nq, span) * o
    return _out(p, h, btype, n_heads * hv), st


def mlstm_step(p, x, n_heads: int, qk: int, hv: int, state: MLSTMState):
    """x: (B, 1, D) -> (y, state).  The per-step recurrence."""
    btype = x.dtype
    b = x.shape[0]
    span = _span(p, n_heads, hv)
    q, k, v, i_g, f_g = _mlstm_qkvif(p, x, n_heads, qk, hv, span)
    qq, kk, vv = (a[:, :, 0].float() for a in (q, k, v))      # (B,H,dim)
    ii, ff = i_g[:, :, 0], f_g[:, :, 0]                        # (B,H)
    lf = F.logsigmoid(ff)
    m_new = torch.maximum(lf + state.m, ii)
    decay = torch.exp(lf + state.m - m_new)
    inject = torch.exp(ii - m_new)
    c_new = decay[..., None, None] * state.c + inject[..., None, None] * (
        kk[..., :, None] * vv[..., None, :])
    n_new = decay[..., None] * state.n + inject[..., None] * kk
    num = torch.einsum("bhkv,bhk->bhv", c_new, qq)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, qq).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, span.nq * hv)
    o = torch.sigmoid((x @ p["w_og"]).float())
    h = _group_norm(h, p["gn_scale"], span.nq, span) * o
    return _out(p, h, btype, n_heads * hv), MLSTMState(c_new, n_new, m_new)


def init_mlstm_state(batch: int, n_heads: int, qk: int, hv: int,
                     device=None) -> MLSTMState:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return MLSTMState(c=z(batch, n_heads, qk, hv), n=z(batch, n_heads, qk),
                      m=z(batch, n_heads))


# ------------------------------------------------------------------- sLSTM
def init_slstm_params(gen: torch.Generator, n: int, d_model: int, n_heads: int,
                      hd: int, dtype, device) -> dict:
    """Gate weights ``w_{z,i,f,o}`` (n, D, H*hd), block-diagonal recurrent
    weights ``r_*`` (n, H, hd, hd), fp32 biases ``b_*`` and ``gn_scale``."""
    dh = n_heads * hd
    p = {"gn_scale": _zeros32(n, dh, device=device),
         "w_out": stacked_dense_init(gen, n, dh, d_model, dtype, device,
                                     1.0 / math.sqrt(2.0))}
    for g in "zifo":
        p[f"w_{g}"] = stacked_dense_init(gen, n, d_model, dh, dtype, device)
        r = torch.randn((n, n_heads, hd, hd), generator=gen, device=device,
                        dtype=torch.float32)
        p[f"r_{g}"] = (r / math.sqrt(hd)).to(dtype)
        p[f"b_{g}"] = _zeros32(n, dh, device=device)
    return p


def _slstm_weights(p, n_heads: int, hd: int, span: HeadSpan):
    """The span's recurrent weights ``r_*`` (H, hd, hd) and biases (H, hd),
    gate by gate; H the span's heads."""
    r = {g: p[f"r_{g}"] for g in "zifo"}
    if span.nq != n_heads:
        r = {g: w[span.h0:span.h0 + span.nq] for g, w in r.items()}
    bias = {g: model_column_range(p[f"b_{g}"], n_heads * hd, span.h0 * hd,
                                  span.nq * hd).reshape(span.nq, hd)
            for g in "zifo"}
    return r, bias


def _slstm_in(p, x, n_heads: int, hd: int, span: HeadSpan):
    """gate -> (..., H, hd) fp32 input contributions (x @ w_g) of the
    span's heads."""
    return {g: _cols(x, p[f"w_{g}"], n_heads, hd, span).float().reshape(
        *x.shape[:-1], span.nq, hd) for g in "zifo"}


def _slstm_cell(r, bias, xw, state: SLSTMState):
    """xw: dict gate -> (B, H, hd) input contributions (x @ w_g); ``r`` and
    ``bias`` from :func:`_slstm_weights`."""
    def rec(g):
        return torch.einsum("bhd,hde->bhe", state.h.to(r[g].dtype), r[g]).float()
    z = torch.tanh(xw["z"] + rec("z") + bias["z"])
    i_t = xw["i"] + rec("i") + bias["i"]
    f_t = xw["f"] + rec("f") + bias["f"]
    o = torch.sigmoid(xw["o"] + rec("o") + bias["o"])
    lf = F.logsigmoid(f_t)
    m_new = torch.maximum(lf + state.m, i_t)
    decay = torch.exp(lf + state.m - m_new)
    inject = torch.exp(i_t - m_new)
    c_new = decay * state.c + inject * z
    n_new = decay * state.n + inject
    h_new = o * c_new / n_new.clamp_min(1e-6)
    return SLSTMState(c_new, n_new, m_new, h_new)


def slstm_sequence(p, x, n_heads: int, hd: int, state: SLSTMState | None = None):
    btype = x.dtype
    b, s, _ = x.shape
    span = _span(p, n_heads, hd)
    if state is None:
        state = init_slstm_state(b, span.nq, hd, x.device)
    xw = _slstm_in(p, x, n_heads, hd, span)
    r, bias = _slstm_weights(p, n_heads, hd, span)
    hs = []
    for t in range(s):
        state = _slstm_cell(r, bias, {g: xw[g][:, t] for g in "zifo"}, state)
        hs.append(state.h)
        if rolled(x):
            hs *= s
            break
    h = torch.stack(hs, dim=1).reshape(b, s, span.nq * hd)
    h = _group_norm(h, p["gn_scale"], span.nq, span)
    return _out(p, h, btype, n_heads * hd), state


def slstm_step(p, x, n_heads: int, hd: int, state: SLSTMState):
    btype = x.dtype
    b = x.shape[0]
    span = _span(p, n_heads, hd)
    xw = _slstm_in(p, x[:, 0], n_heads, hd, span)
    r, bias = _slstm_weights(p, n_heads, hd, span)
    st = _slstm_cell(r, bias, xw, state)
    h = _group_norm(st.h.reshape(b, 1, span.nq * hd), p["gn_scale"], span.nq, span)
    return _out(p, h, btype, n_heads * hd), st


def init_slstm_state(batch: int, n_heads: int, hd: int,
                     device=None) -> SLSTMState:
    z = torch.zeros((batch, n_heads, hd), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z.clone(), m=z.clone(), h=z.clone())
