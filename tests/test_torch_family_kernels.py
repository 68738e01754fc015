"""repro_torch MoE gating, SSM scan and mLSTM scan: the port's entry points on
CPU tensors (the kernels' plain versions) against the reference's oracles in
``repro.kernels.ref`` and its Pallas kernels in interpret mode, over the
sweeps of ``tests/test_kernels.py``; a router tie; the wrappers' argument
checks, which run before any launch; the bounds.

Tolerances: gating ``idx`` and ``pos`` exact, gates 1e-6; the SSM scan 1e-4
and the mLSTM scan 2e-3 in fp32 (the reference's own, the second because the
chunkwise Pallas kernel applies the stabiliser at other points than the
per-step recurrence)."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mlstm_scan import mlstm_scan as pallas_mlstm
from repro.kernels.moe_gating import moe_gating as pallas_gating
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm
from repro_torch.kernels import mlstm_scan as ml, moe_gating as mg, ops, ssm_scan as ss

SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# (t, e, k, block_t): test_moe_gating's sweep
GATING_SWEEP = [(100, 8, 2, 32), (256, 16, 4, 64), (40, 4, 1, 16)]
# (b, s, d, n, block_d, chunk): test_ssm_scan's sweep
SSM_SWEEP = [(2, 128, 64, 16, 32, 32), (1, 64, 128, 8, 128, 16)]
# (b, h, s, dqk, dv, chunk): test_mlstm_scan's sweep
MLSTM_SWEEP = [(1, 2, 128, 32, 64, 32), (2, 2, 64, 16, 16, 16)]


def ident(shape):
    return "-".join(map(str, shape))


def t_(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------------ gating
def gating_logits(seed, t, e):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)


def check_gating(got, jax_out):
    idx, gates, pos = got
    assert idx.dtype == pos.dtype == torch.int32 and gates.dtype == torch.float32
    assert (idx.numpy() == np.asarray(jax_out[0])).all()
    assert (pos.numpy() == np.asarray(jax_out[2])).all()
    np.testing.assert_allclose(gates.numpy(), np.asarray(jax_out[1]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", GATING_SWEEP, ids=ident)
def test_gating_plain_matches_reference_kernel_and_oracle(shape):
    t, e, k, bt = shape
    lg = gating_logits(0, t, e)
    got = ops.moe_gating(t_(lg), k, block_t=bt)
    check_gating(got, jref.moe_gating_ref(jnp.asarray(lg), k, capacity=1 << 30))
    check_gating(got, pallas_gating(jnp.asarray(lg), k, block_t=bt, interpret=True))


def test_gating_ties_go_to_the_lower_expert():
    """Equal logits, as a bf16 router product cast to fp32 gives them: the
    lower index first, as ``lax.top_k`` and the Pallas kernel pick."""
    lg = gating_logits(1, 64, 8)
    lg[0] = 0.25                              # a row of eight equal logits
    lg[1, [2, 5, 6]] = 9.0                    # a three-way tie at the top
    lg[2, [3, 7]] = 7.0                       # a tie for second place
    lg[2, 0] = 8.0
    lg = np.asarray(jnp.asarray(lg, jnp.bfloat16).astype(jnp.float32))
    got = ops.moe_gating(t_(lg), 2)
    assert got[0][0].tolist() == [0, 1]
    assert got[0][1].tolist() == [2, 5]
    assert got[0][2].tolist() == [0, 3]
    check_gating(got, jref.moe_gating_ref(jnp.asarray(lg), 2, capacity=1 << 30))
    check_gating(got, pallas_gating(jnp.asarray(lg), 2, block_t=16, interpret=True))


def test_gating_bf16_logits():
    lg = gating_logits(2, 48, 8)
    jl = jnp.asarray(lg, jnp.bfloat16)
    got = ops.moe_gating(t_(lg, torch.bfloat16), 2)
    check_gating(got, jref.moe_gating_ref(jl, 2, capacity=1 << 30))


# --------------------------------------------------------------------- ssm
def ssm_inputs(seed, b, s, d, n):
    """As test_ssm_scan: dt a small positive softplus, a negative."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, d)))) * 0.2).astype(np.float32)
    bt = rng.standard_normal((b, s, n)).astype(np.float32)
    ct = rng.standard_normal((b, s, n)).astype(np.float32)
    a = -np.abs(rng.standard_normal((d, n))).astype(np.float32)
    return x, dt, bt, ct, a


@pytest.mark.parametrize("shape", SSM_SWEEP, ids=ident)
def test_ssm_plain_matches_reference_kernel_and_oracle(shape):
    b, s, d, n, bd, ch = shape
    arrs = ssm_inputs(3, b, s, d, n)
    got = f32(ops.ssm_scan(*map(t_, arrs), block_d=bd, chunk=ch))
    jargs = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(got, f32(jref.ssm_scan_ref(*jargs)[0]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, f32(pallas_ssm(*jargs, block_d=bd, chunk=ch,
                                                   interpret=True)), atol=1e-4, rtol=0)


def test_ssm_bf16_x_matches_the_pallas_kernel():
    """x (and so y) in bf16 with the fp32 coefficients the model gives: both
    compute in fp32 and round y once."""
    arrs = ssm_inputs(4, 1, 64, 64, 16)
    x16 = jnp.asarray(arrs[0], jnp.bfloat16)
    got = ops.ssm_scan(t_(arrs[0], torch.bfloat16), *map(t_, arrs[1:]), block_d=64, chunk=32)
    assert got.dtype == torch.bfloat16
    want = pallas_ssm(x16, *[jnp.asarray(a) for a in arrs[1:]], block_d=64, chunk=32,
                      interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), atol=3e-2, rtol=1e-2)


# ------------------------------------------------------------------- mlstm
def mlstm_inputs(seed, b, h, s, dq, dv):
    """As test_mlstm_scan: forget gates shifted towards remembering."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, dq)).astype(np.float32)
    k = rng.standard_normal((b, h, s, dq)).astype(np.float32)
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    ig = rng.standard_normal((b, h, s)).astype(np.float32)
    fg = (rng.standard_normal((b, h, s)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("shape", MLSTM_SWEEP, ids=ident)
def test_mlstm_plain_matches_reference_kernel_and_oracle(shape):
    b, h, s, dq, dv, ch = shape
    arrs = mlstm_inputs(5, b, h, s, dq, dv)
    got = f32(ops.mlstm_scan(*map(t_, arrs), chunk=ch))
    jargs = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(got, f32(jref.mlstm_ref(*jargs)), atol=2e-3, rtol=0)
    np.testing.assert_allclose(got, f32(pallas_mlstm(*jargs, chunk=ch, interpret=True)),
                               atol=2e-3, rtol=0)


def test_mlstm_plain_is_the_oracle_recurrence():
    """Same order of operations as ``ref.mlstm_ref``: far inside 2e-3."""
    arrs = mlstm_inputs(6, 1, 2, 48, 8, 16)
    got = f32(ml.mlstm_scan_plain(*map(t_, arrs)))
    want = f32(jref.mlstm_ref(*[jnp.asarray(a) for a in arrs]))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------- wrappers: CPU, checks, bounds
def _cases():
    return {
        "moe_gating": (mg.moe_gating, (t_(gating_logits(7, 40, 8)), 2)),
        "ssm_scan": (ss.ssm_scan, tuple(map(t_, ssm_inputs(8, 1, 64, 32, 8)))),
        "mlstm_scan": (ml.mlstm_scan, tuple(map(t_, mlstm_inputs(9, 1, 2, 64, 16, 16)))),
    }


@pytest.mark.parametrize("name", ["moe_gating", "ssm_scan", "mlstm_scan"])
def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch(name):
    wrapper, args = _cases()[name]
    plain = {"moe_gating": mg.moe_gating_plain, "ssm_scan": ss.ssm_scan_plain,
             "mlstm_scan": ml.mlstm_scan_plain}[name]
    before = wrapper.launches
    got = getattr(ops, name)(*args)
    want = plain(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert wrapper.launches == before


@pytest.mark.parametrize("name", ["moe_gating", "ssm_scan", "mlstm_scan"])
def test_wrapper_raises_by_name_where_it_has_no_kernel(name):
    """A tensor on a device with neither the CUDA kernel nor the plain
    version (``meta``): the wrapper raises, naming its kernel, after the same
    argument checks."""
    _, args = _cases()[name]
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(RuntimeError, match=name):
        getattr(ops, name)(*meta)


def _gate_args():
    return [t_(gating_logits(10, 16, 8)), 2]


def _ssm_args():
    return list(map(t_, ssm_inputs(11, 1, 64, 64, 16)))


def _mlstm_args():
    return list(map(t_, mlstm_inputs(12, 1, 2, 64, 16, 16)))


def _set(i, fn):
    def breaker(a):
        a[i] = fn(a[i])
    breaker.__name__ = f"arg{i}_{getattr(fn, '__name__', 'x')}"
    return breaker


def halfp(x):
    return x.half()


def bf16(x):
    return x.bfloat16()


def drop_step(x):
    return x[:, :, :-1].contiguous()


def noncontig(x):
    return x.transpose(-1, -2).contiguous().transpose(-1, -2)


def k_nine(_):
    return 9


def state_3(x):
    return x[..., :3].contiguous()


@pytest.mark.parametrize("kernel,args,breaker,exc", [
    ("moe_gating", _gate_args, _set(0, halfp), TypeError),
    ("moe_gating", _gate_args, _set(1, k_nine), ValueError),
    ("moe_gating", _gate_args, _set(0, noncontig), ValueError),
    ("ssm_scan", _ssm_args, _set(1, bf16), TypeError),
    ("ssm_scan", _ssm_args, _set(2, state_3), ValueError),
    ("ssm_scan", _ssm_args, _set(0, noncontig), ValueError),
    ("mlstm_scan", _mlstm_args, _set(3, bf16), TypeError),
    ("mlstm_scan", _mlstm_args, _set(1, bf16), TypeError),
    ("mlstm_scan", _mlstm_args, _set(2, drop_step), ValueError)],
    ids=lambda x: getattr(x, "__name__", x if isinstance(x, str) else ""))
def test_wrapper_raises_before_any_launch(kernel, args, breaker, exc):
    """What the CUDA kernel cannot take raises in the wrapper, for a tensor
    on any device, instead of giving way to the plain version."""
    a = args()
    breaker(a)
    with pytest.raises(exc):
        getattr(ops, kernel)(*a)


def test_reference_argument_checks_are_kept():
    """``S % chunk`` and ``D % min(block_d, D)``, as the reference asserts;
    a block_d larger than D is clamped, as there."""
    with pytest.raises(ValueError, match="chunk"):
        ops.ssm_scan(*_ssm_args(), chunk=48)
    with pytest.raises(ValueError, match="block_d"):
        ops.ssm_scan(*_ssm_args(), block_d=48)
    ops.ssm_scan(*_ssm_args(), block_d=256, chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        ops.mlstm_scan(*_mlstm_args(), chunk=48)


@pytest.mark.parametrize("name", ["moe_gating", "ssm_scan", "mlstm_scan"])
def test_wrapper_has_no_fallback_from_the_kernel(name):
    """Source-level guard: no ``try`` in the wrapper, and the plain version
    only behind the CPU check."""
    tree = ast.parse((SRC / "kernels" / f"{name}.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)
    assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)]
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == f"{name}_plain"]
    assert len(calls) == 1
    guard = next(n for n in ast.walk(fn) if isinstance(n, ast.If) and calls[0] in ast.walk(n))
    assert "cpu" in ast.unparse(guard.test)


def test_bounds_count_each_byte_and_operation_once():
    assert mg.live_bytes(4096, 8, 2, 4) == 4096 * 8 * 4 + 4096 * 2 * 12
    assert mg.bound_ms(4096, 8, 2, 4)[1] == "bytes"
    # Hymba's width: N = 16 states per channel, 14 fp32 operations per byte
    # against the card's 20: bound by bytes
    ms, by = ss.bound_ms(8, 1024, 1600, 16, 2)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * ss.live_bytes(8, 1024, 1600, 16, 2) / 3.35e12)
    assert ss.bound_ms(8, 1024, 1600, 64, 2)[1] == "operations"
    assert ss.live_bytes(1, 2, 3, 4, 2) == 2 * (3 * 8 + 32) + 48
    # xLSTM's width, dqk 256, dv 512: against the tensor cores' rate bf16 is
    # bound by bytes, fp32 by the fp32 units' operations
    ms, by = ml.bound_ms(8, 4, 256, 256, 512, torch.bfloat16)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 8 * 4 * 256 * (2 * (512 + 1024) + 8) / 3.35e12)
    ms, by = ml.bound_ms(8, 4, 256, 256, 512, torch.float32)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 8 * 4 * 256 * (4 * 256 * 512 + 4 * 256) / 67e12)

