"""Mamba-style selective SSM used by Hymba's parallel SSM heads.

Counterpart of ``src/repro/models/ssm.py``.  Sequence mode runs the
selective scan chunk by chunk with the fp32 state carried between chunks,
as the reference does.  Inside a chunk the reference composes the
``(decay, input)`` pairs with ``lax.associative_scan``, which PyTorch lacks;
here the same composition ``(a1, b1) . (a2, b2) = (a2 a1, a2 b1 + b2)``
runs as a log-depth (Hillis-Steele) inclusive scan over the chunk: the same
recurrence summed in another order, within 1e-4 of the reference in fp32.
Decode mode is the O(1) single-step recurrence with a conv ring buffer.

On a mesh (``distributed.sharding.param_specs``) a process holds a ``model``
slice of the channels: ``conv_w``, ``conv_b``, ``w_dt_out``, ``dt_bias``,
``A_log`` and ``D_skip`` cut by channel, and ``w_in`` by its ``2 * d_inner``
columns, so that a process's columns may hold one of the ``x`` / ``z``
halves only.  ``x @ w_in`` is gathered and this process's channels of both
halves taken; the scan is per channel; the products whose contracted dim is
``d_inner`` (``w_dt_in``, ``w_B``, ``w_C``, ``w_out``, cut by rows) are
summed over ``model``.  The state stays cut by channel.  ``d_inner`` is the
config's (the functions read it off ``w_in`` when it is not given, which
holds only for uncut parameters).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.context import model_columns, model_rank, model_row_sum
from .layers import rolled, stacked_dense_init


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, cw-1, di) last conv inputs
    h: torch.Tensor      # (B, di, n) fp32 SSM state


def init_ssm_params(gen: torch.Generator, n: int, d_model: int, d_inner: int,
                    n_state: int, conv_width: int, dtype, device) -> dict:
    """``n`` stacked layers of the reference's SSM parameters; ``dt_bias``,
    ``A_log`` and ``D_skip`` are fp32."""
    dt_rank = max(16, d_model // 16)

    def dense(d_in, d_out):
        return stacked_dense_init(gen, n, d_in, d_out, dtype, device)

    def f32(*shape, value):
        return torch.full((n, *shape), value, dtype=torch.float32, device=device)

    conv_w = torch.randn((n, conv_width, d_inner), generator=gen, device=device,
                         dtype=torch.float32) / conv_width ** 0.5
    a_log = torch.log(torch.arange(1, n_state + 1, dtype=torch.float32,
                                   device=device)).expand(n, d_inner, n_state)
    return {
        "w_in": dense(d_model, 2 * d_inner),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((n, d_inner), dtype=dtype, device=device),
        "w_dt_in": dense(d_inner, dt_rank),
        "w_dt_out": dense(dt_rank, d_inner),
        "dt_bias": f32(d_inner, value=-2.0),               # softplus^-1(~0.12)
        "w_B": dense(d_inner, n_state),
        "w_C": dense(d_inner, n_state),
        "A_log": a_log.contiguous(),
        "D_skip": f32(d_inner, value=1.0),
        "w_out": dense(d_inner, d_model),
    }


def _conv_causal(x, w, b):
    """Depthwise causal conv: x (B, S, di), w (cw, di)."""
    cw = w.shape[0]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(cw))
    return out + b


def _d_inner(p, d_inner) -> int:
    return d_inner or p["w_in"].shape[-1] // 2


def _in_proj(p, x, di: int):
    """x (B, S, D) -> (x_in, z) (B, S, c): this process's c channels of the
    scan's input and of the gate branch."""
    xz = model_columns(x @ p["w_in"], 2 * di)
    c = p["conv_b"].shape[-1]
    if c == di:
        return xz[..., :di], xz[..., di:]
    c0 = model_rank() * c
    return xz[..., c0:c0 + c], xz[..., di + c0:di + c0 + c]


def _channel_sum(p, y, name: str, di: int):
    """``y``, a product through ``p[name]`` (rows: channels), summed over
    ``model`` when the channels are a cut."""
    return model_row_sum(y, p[name].shape[-2], di)


def _ssm_coeffs(p, x_c, d_inner=None):
    """x_c (B, S, di) -> dt (B, S, di) fp32, a (di, n), b_t and c_t
    (B, S, n) fp32: the inputs of the selective scan."""
    di = _d_inner(p, d_inner)
    dt_low = _channel_sum(p, x_c @ p["w_dt_in"], "w_dt_in", di)
    dt = F.softplus((dt_low @ p["w_dt_out"]).float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    b_t = _channel_sum(p, x_c @ p["w_B"], "w_B", di).float()
    c_t = _channel_sum(p, x_c @ p["w_C"], "w_C", di).float()
    return dt, a, b_t, c_t


def pick_chunk(s: int, chunk: int) -> int:
    """Largest divisor of s that is <= chunk (exactness over padding)."""
    for c in range(min(chunk, s), 0, -1):
        if s % c == 0:
            return c
    return 1


def _inclusive_scan(da, dbx):
    """Compose (decay, input) pairs along dim 1: returns (A_t, B_t) with
    h_t = A_t h_0 + B_t.  Log-depth; each level is built out of place (the
    products of a level keep the tensors of the level before for autograd)."""
    a, b = da, dbx
    t, off = a.shape[1], 1
    while off < t:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def ssm_conv_input(p, x, d_inner=None):
    """x (B, S, D) -> (x_c, z): the causal conv's activated output (B, S,
    di), the input of the selective scan, and the gate branch."""
    x_in, z = _in_proj(p, x, _d_inner(p, d_inner))
    return F.silu(_conv_causal(x_in, p["conv_w"], p["conv_b"])), z


def ssm_scan_chunked(p, x_c, chunk: int, h0=None, d_inner=None):
    """The selective scan of :func:`ssm_sequence` on the conv output x_c
    (B, S, di): y = C h in fp32 before the ``D_skip`` term, and the final
    state (B, di, n).  The coefficients are computed over the whole sequence
    (the reference computes them chunk by chunk: the same rows)."""
    bsz, s, di = x_c.shape
    dt, a, b_t, c_t = _ssm_coeffs(p, x_c, d_inner)
    h = (torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32, device=x_c.device)
         if h0 is None else h0)
    chunk = pick_chunk(s, chunk)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        da = torch.exp(dt[:, sl, :, None] * a)                    # (B,T,di,n)
        dbx = (dt[:, sl] * x_c[:, sl].float())[..., None] * b_t[:, sl, None, :]
        a_sc, b_sc = _inclusive_scan(da, dbx)
        h_t = b_sc + a_sc * h[:, None]
        ys.append(torch.einsum("btdn,btn->btd", h_t, c_t[:, sl]))
        h = h_t[:, -1]
        if rolled(x_c):
            ys *= s // chunk
            break
    return torch.cat(ys, dim=1), h


def _sequence(p, x, chunk: int, h0, di: int):
    """(y, final state, the conv's input x_in) of :func:`ssm_sequence`."""
    x_in, z = _in_proj(p, x, di)
    x_c = F.silu(_conv_causal(x_in, p["conv_w"], p["conv_b"]))
    y, h_fin = ssm_scan_chunked(p, x_c, chunk, h0, di)
    y = (y + p["D_skip"] * x_c.float()).to(x.dtype)
    y = y * F.silu(z)
    return _channel_sum(p, y @ p["w_out"], "w_out", di), h_fin, x_in


def ssm_sequence(p, x, chunk: int = 128, h0=None, d_inner=None):
    """x: (B, S, D) -> (y (B, S, D), final SSM state h (B, di, n))."""
    y, h_fin, _ = _sequence(p, x, chunk, h0, _d_inner(p, d_inner))
    return y, h_fin


def ssm_prefill_state(p, x, chunk: int = 128, d_inner=None):
    """Run the sequence and also return the conv ring for decode."""
    y, h, x_in = _sequence(p, x, chunk, None, _d_inner(p, d_inner))
    cw = p["conv_w"].shape[0]
    return y, SSMState(conv=x_in[:, -(cw - 1):, :], h=h)


def ssm_step(p, x, state: SSMState, d_inner=None):
    """x: (B, 1, D) -> (y (B, 1, D), new state)."""
    btype = x.dtype
    di = _d_inner(p, d_inner)
    x_in, z = _in_proj(p, x, di)                               # (B,1,c)
    hist = torch.cat([state.conv, x_in], dim=1)                # (B,cw,c)
    x_c = F.silu((hist * p["conv_w"]).sum(dim=1, keepdim=True) + p["conv_b"])
    dt, a, b_t, c_t = _ssm_coeffs(p, x_c, di)                  # (B,1,..)
    da = torch.exp(dt[:, 0, :, None] * a)                      # (B,di,n)
    dbx = (dt[:, 0] * x_c[:, 0].float())[..., None] * b_t[:, 0, None, :]
    h = da * state.h + dbx
    y = torch.einsum("bdn,bn->bd", h, c_t[:, 0])[:, None, :]
    y = y + p["D_skip"] * x_c.float()
    y = y.to(btype) * F.silu(z)
    y = _channel_sum(p, y @ p["w_out"], "w_out", di)
    return y, SSMState(conv=hist[:, 1:], h=h)


def init_ssm_state(batch: int, d_inner: int, n_state: int, conv_width: int,
                   dtype, device=None) -> SSMState:
    return SSMState(
        conv=torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, d_inner, n_state), dtype=torch.float32,
                      device=device))
