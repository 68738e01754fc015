"""Mamba selective scan: the CUDA kernel's wrapper and its plain version.

Counterpart of ``src/repro/kernels/ssm_scan.py`` (``ssm_scan``, the Pallas
TPU kernel) and of ``src/repro/kernels/ref.py`` (``ssm_scan_ref``, here
:func:`ssm_scan_plain`).

Source note.  ``csrc/ssm_scan.cu`` replaces the Pallas kernel
``repro/kernels/ssm_scan.py::ssm_scan``.  Per (b, s, d, n) the function
does one exp and a few multiply-adds in fp32 against x, dt, b_t, c_t, a and
y moved once each: at Hymba's N = 16 about 14 operations per byte of bf16 x,
under the H100's 20 fp32 operations per byte of memory rate, so it is bound
by bytes there, and by operations from N = 32 on (:func:`bound_ms`).  The
exps have a floor of their own: the card's special-function units give 16 a
clock an SM (:func:`exp_floor_ms`, 0.0125 ms at Hymba's layer 0, above its
0.0079 ms bytes bound).  The design (:func:`ssm_plan`): a channel's N states
split over a few adjacent lanes of a warp (2 lanes x 8 states at N 16), y
summed over them by warp shuffles, so B * D * lanes threads fill the card in
one wave; for bf16 x ``exp(dt a)`` as one ``ex2.approx`` of
``dt * (a log2 e)``, a scaled once a thread (:func:`ssm_scan_exp2_plain` is
that arithmetic in PyTorch), for fp32 x :func:`ssm_scan_plain`'s own
arithmetic (``expf``, no multiply-add), since over a long sequence a slow
decay adds up any bias of the exp past fp32's tolerance; ``STEPS`` steps of
x, dt, b_t and c_t staged by ``cp.async`` into one buffer while the other is
computed.  The first design (one thread a channel, N states each, B * D / 128
blocks) took 0.067 ms at Hymba's layer 0 (``PERF.md`` §6).

The recurrence's coefficients (dt, b_t, c_t, a) are fp32, as the model
produces them; x and y are fp32 or bf16.  A CUDA tensor goes to the kernel or
raises; only a CPU tensor takes the plain version.  ``ssm_scan.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..launch.mesh import HBM_BW, PEAK_FLOPS_FP32
from . import _build

SUPPORTED_STATES = (4, 8, 16, 32, 64)
OPS_PER_STATE = 7                  # dt*a, exp, h = da*h + dx*b (3), y += h*c (2)
SMS = 132                          # H100 SXM streaming multiprocessors
EXPS_PER_CLOCK_SM = 16             # special-function unit results a clock an SM
BOOST_CLOCK_HZ = 1.98e9            # H100 SXM boost clock
THREADS = 128                      # ssm_scan.cu::kThreads
STEPS = 16                         # steps a staging buffer holds; ssm_scan.cu::kSteps
LOG2E = 1.4426950408889634
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class SsmPlan(NamedTuple):
    """How the kernel splits the work (``ssm_scan.cu::Split``): ``lanes``
    adjacent lanes of a warp hold a channel's N states, ``states`` each;
    a block of ``THREADS`` threads holds ``channels`` channels of one
    sequence; ``blocks`` blocks cover the D channels of a sequence."""
    lanes: int
    states: int
    channels: int
    blocks: int

    def owner(self, block: int, tid: int) -> tuple[int, range]:
        """The channel and the states thread ``tid`` of channel block
        ``block`` holds (the kernel's index arithmetic)."""
        return (block * self.channels + tid // self.lanes,
                range(tid % self.lanes * self.states, (tid % self.lanes + 1) * self.states))


def ssm_plan(d: int, n: int) -> SsmPlan:
    """The split for D channels of N states: up to 8 states a thread, so
    that a channel takes 1, 1, 2, 4 or 8 lanes at N 4, 8, 16, 32, 64."""
    if n not in SUPPORTED_STATES:
        raise ValueError(f"state size {n} not supported: {SUPPORTED_STATES}")
    states = min(n, 8)
    lanes = n // states
    channels = THREADS // lanes
    return SsmPlan(lanes, states, channels, -(-d // channels))


def ssm_scan_plain(x, dt, b_t, c_t, a):
    """The sequential recurrence in fp32, as ``ref.ssm_scan_ref``; y in x's
    dtype.  x, dt (B, S, D); b_t, c_t (B, S, N); a (D, N)."""
    bsz, s, d = x.shape
    h = torch.zeros((bsz, d, a.shape[1]), dtype=torch.float32, device=x.device)
    xf, dtf, bf, cf, af = (t.float() for t in (x, dt, b_t, c_t, a))
    ys = []
    for t in range(s):
        h = (torch.exp(dtf[:, t, :, None] * af) * h
             + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssm_scan_exp2_plain(x, dt, b_t, c_t, a):
    """The kernel's arithmetic for bf16 x, in fp32 PyTorch: the decay as
    ``2 ** (dt * (a * log2 e))`` with ``a * log2 e`` rounded to fp32 once, as
    the kernel scales a once a thread; y summed over each lane's states,
    then over the channel's lanes (:func:`ssm_plan`).  y in x's dtype."""
    bsz, s, d = x.shape
    n = a.shape[1]
    plan = ssm_plan(d, n)
    a2 = a.float() * LOG2E
    h = torch.zeros((bsz, d, n), dtype=torch.float32, device=x.device)
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b_t, c_t))
    ys = []
    for t in range(s):
        h = (torch.exp2(dtf[:, t, :, None] * a2) * h
             + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :])
        part = (h * cf[:, t, None, :]).reshape(bsz, d, plan.lanes, plan.states).sum(-1)
        ys.append(part.sum(-1))
    return torch.stack(ys, dim=1).to(x.dtype)


def check_args(x, dt, b_t, c_t, a) -> None:
    """Raise on anything the CUDA kernel cannot take, for a tensor on any
    device.  Touches no data."""
    if x.dim() != 3 or b_t.dim() != 3 or a.dim() != 2:
        raise ValueError(f"x, dt must be (B, S, D), b_t, c_t (B, S, N), a (D, N); "
                         f"got {tuple(x.shape)}, {tuple(b_t.shape)}, {tuple(a.shape)}")
    bsz, s, d = x.shape
    n = a.shape[1]
    if dt.shape != x.shape:
        raise ValueError(f"dt {tuple(dt.shape)} differs from x {tuple(x.shape)}")
    if b_t.shape != (bsz, s, n) or c_t.shape != (bsz, s, n) or a.shape != (d, n):
        raise ValueError(f"b_t {tuple(b_t.shape)}, c_t {tuple(c_t.shape)}, "
                         f"a {tuple(a.shape)} do not fit x {tuple(x.shape)}")
    if n not in SUPPORTED_STATES:
        raise ValueError(f"state size {n} not supported: the kernel is built "
                         f"for {SUPPORTED_STATES}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    for name, t in (("dt", dt), ("b_t", b_t), ("c_t", c_t), ("a", a)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("dt", dt), ("b_t", b_t), ("c_t", c_t), ("a", a)):
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def ssm_scan(x, dt, b_t, c_t, a, *, block_d: int = 256, chunk: int = 64):
    """x, dt: (B, S, D); b_t, c_t: (B, S, N); a: (D, N) -> y (B, S, D) in
    x's dtype.  As in the reference, S must be a multiple of ``chunk`` and D
    of ``min(block_d, D)``; the kernel itself needs neither (it stages
    ``STEPS`` steps of a block's channels, :func:`ssm_plan`) and its result
    does not depend on them."""
    check_args(x, dt, b_t, c_t, a)
    bsz, s, d = x.shape
    bd = min(block_d, d)
    if chunk < 1 or s % chunk or bd < 1 or d % bd:
        raise ValueError(f"S = {s} must be a multiple of chunk = {chunk} and "
                         f"D = {d} of block_d = {bd} (callers pad)")
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, b_t, c_t, a)
    if x.device.type != "cuda":
        raise RuntimeError(f"no ssm_scan kernel for {x.device}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn = _launcher()
    plan = ssm_plan(d, a.shape[1])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), b_t.data_ptr(), c_t.data_ptr(),
                a.data_ptr(), y.data_ptr(), bsz, s, d, a.shape[1], plan.lanes,
                _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan_launch failed with code {rc} for x "
                           f"{tuple(x.shape)} {x.dtype}, N {a.shape[1]}, {plan}")
    ssm_scan.launches += 1
    return y


ssm_scan.launches = 0


def _launcher():
    fn = _build.load("ssm_scan").ssm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def live_bytes(bsz: int, s: int, d: int, n: int, itemsize: int) -> int:
    """Bytes the function must move: x and y in their type, dt, b_t, c_t
    and a in fp32, each once."""
    return bsz * s * (d * (2 * itemsize + 4) + 8 * n) + 4 * d * n


def bound_ms(bsz: int, s: int, d: int, n: int, itemsize: int):
    """Least time an H100 could take: the larger of :func:`live_bytes` over
    the memory rate and ``OPS_PER_STATE`` fp32 operations per (b, s, d, n),
    one exp among them, over the fp32 peak.  Returns ``(ms, "bytes" |
    "operations")``."""
    ops = OPS_PER_STATE * bsz * s * d * n
    return max((1e3 * live_bytes(bsz, s, d, n, itemsize) / HBM_BW, "bytes"),
               (1e3 * ops / PEAK_FLOPS_FP32, "operations"))


def exp_floor_ms(bsz: int, s: int, d: int, n: int) -> float:
    """The time the exps alone take at the special-function units' rate,
    one a (b, s, d, n): the floor of any design with one exp a state-step
    (not a bound on the function, which could compute some exps on the FMA
    pipe)."""
    return 1e3 * bsz * s * d * n / (SMS * EXPS_PER_CLOCK_SM * BOOST_CLOCK_HZ)
