"""repro_torch flash and decode attention: the port's entry points on CPU
tensors (the kernels' plain versions) against the reference's oracles and its
Pallas kernels in interpret mode, over the sweeps of ``tests/test_kernels.py``;
the wrappers' argument checks, which run before any launch; the bounds."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import decode_attention as da, flash_attention as fa, ops

SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# the reference's own tolerances (tests/test_kernels.py)
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (b, h, kv, s, hd, window): test_flash_attention's sweep (causal)
FLASH_SWEEP = [(2, 4, 2, 128, 64, 0), (1, 4, 4, 256, 32, 0), (2, 8, 2, 128, 64, 64),
               (1, 2, 1, 96, 64, 32), (1, 2, 2, 160, 128, 0)]
# (b, h, kv, sq, sk, hd): test_flash_attention_prepended_kv's sweep
PREPENDED = [(2, 4, 2, 64, 192, 64), (1, 4, 4, 96, 256, 32), (1, 2, 1, 32, 96, 64)]
# (b, h, kv, s, hd, fill): test_decode_attention's sweep
DECODE_SWEEP = [(2, 8, 2, 256, 64, 256), (1, 4, 4, 128, 128, 100), (2, 4, 1, 96, 64, 50)]


def ident(shape):
    return "-".join(map(str, shape))


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def to_jax(arrs, dtype):
    return [jnp.asarray(a, JDT[dtype]) if a.dtype == np.float32 else jnp.asarray(a)
            for a in arrs]


def to_torch(arrs, dtype):
    return [torch.from_numpy(a).to(TDT[dtype]) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrs]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def decode_pos(s, fill):
    return np.where(np.arange(s) < fill, np.arange(s), -1).astype(np.int32)


# ------------------------------------------------------------------ flash
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SWEEP, ids=ident)
def test_flash_matches_reference_oracle(shape, dtype):
    b, h, kv, s, hd, win = shape
    arrs = arrays(0, (b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd))
    got = ops.flash_attention(*to_torch(arrs, dtype), causal=True, window=win)
    want = jref.attention_ref(*to_jax(arrs, dtype), causal=True, window=win)
    assert got.dtype == TDT[dtype] and got.shape == (b, h, s, hd)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PREPENDED, ids=ident)
def test_flash_prepended_kv_matches_oracle_and_monolithic_suffix(shape, dtype):
    """Chunked prefill over prepended KV: q_offset = Sk - Sq gives the offset
    oracle's rows and the suffix rows of the monolithic run."""
    b, h, kv, sq, sk, hd = shape
    off = sk - sq
    arrs = arrays(1, (b, h, sk, hd), (b, kv, sk, hd), (b, kv, sk, hd))
    q_full, k, v = to_torch(arrs, dtype)
    q = q_full[:, :, off:].contiguous()
    got = ops.flash_attention(q, k, v, causal=True, q_offset=off)
    jq, jk, jv = to_jax(arrs, dtype)
    want = jref.attention_ref(jq[:, :, off:], jk, jv, causal=True, q_offset=off)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL[dtype], rtol=0)
    mono = ops.flash_attention(q_full, k, v, causal=True)[:, :, off:]
    np.testing.assert_allclose(f32(got), f32(mono), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("window,q_offset", [(0, 0), (24, 0), (0, 40)])
def test_flash_matches_the_pallas_kernel(window, q_offset):
    """One small case against the reference's Pallas kernel, interpreted."""
    b, h, kv, sq, hd = 1, 4, 2, 48, 32
    sk = sq + q_offset
    arrs = arrays(2, (b, h, sq, hd), (b, kv, sk, hd), (b, kv, sk, hd))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = ops.flash_attention(*to_torch(arrs, "float32"), **kw)
    want = pallas_flash(*to_jax(arrs, "float32"), block_q=16, block_k=16,
                        interpret=True, **kw)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL["float32"], rtol=0)


@pytest.mark.parametrize("block_q,block_k", [(16, 16), (128, 32), (7, 300)])
def test_flash_tiling_hints_do_not_change_the_result(block_q, block_k):
    arrs = to_torch(arrays(3, (1, 2, 40, 32), (1, 2, 40, 32), (1, 2, 40, 32)), "float32")
    base = ops.flash_attention(*arrs)
    assert torch.equal(ops.flash_attention(*arrs, block_q=block_q, block_k=block_k), base)


def test_flash_non_causal_and_mask_of_absolute_positions():
    arrs = arrays(4, (2, 2, 8, 32), (2, 1, 20, 32), (2, 1, 20, 32))
    for kw in (dict(causal=False), dict(causal=False, window=5, q_offset=12),
               dict(causal=True, window=3, q_offset=12)):
        got = ops.flash_attention(*to_torch(arrs, "float32"), **kw)
        want = jref.attention_ref(*to_jax(arrs, "float32"), **kw)
        np.testing.assert_allclose(f32(got), f32(want), atol=ATOL["float32"], rtol=0)
    mask = fa.attention_mask(3, 6, causal=True, window=2, q_offset=3)
    assert mask.tolist() == [[False, False, True, True, False, False],
                             [False, False, False, True, True, False],
                             [False, False, False, False, True, True]]


# ----------------------------------------------------------------- decode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DECODE_SWEEP, ids=ident)
def test_decode_matches_reference_oracle(shape, dtype):
    b, h, kv, s, hd, fill = shape
    arrs = arrays(5, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd)) + [decode_pos(s, fill)]
    got = ops.decode_attention(*to_torch(arrs, dtype))
    want = jref.decode_attention_ref(*to_jax(arrs, dtype))
    assert got.dtype == TDT[dtype] and got.shape == (b, h, hd)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("fill", [37, 64])
def test_decode_matches_the_pallas_kernel(fill):
    b, h, kv, s, hd = 2, 4, 2, 64, 32
    arrs = arrays(6, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd)) + [decode_pos(s, fill)]
    got = ops.decode_attention(*to_torch(arrs, "float32"))
    want = pallas_decode(*to_jax(arrs, "float32"), block_k=16, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL["float32"], rtol=0)


def test_decode_ring_positions_and_stale_slots():
    """Validity is ``pos >= 0`` wherever the slot lies (a wrapped ring), and
    what an empty slot holds, even inf or nan, never reaches the result."""
    b, h, kv, s, hd = 2, 4, 2, 16, 32
    q, kc, vc = arrays(7, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    pos = np.array([16, 17, 18, -1, -1, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15], np.int32)
    want = jref.decode_attention_ref(*to_jax([q, kc, vc, pos], "float32"))
    kd, vd = kc.copy(), vc.copy()
    kd[:, pos < 0], vd[:, pos < 0] = np.inf, np.nan
    got = ops.decode_attention(*to_torch([q, kd, vd, pos], "float32"))
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL["float32"], rtol=0)


def test_all_invalid_decode_row_gives_zero():
    """No occupied slot: the Pallas kernel's zeroed V gives 0, and so does
    the port."""
    b, h, kv, s, hd = 2, 4, 2, 32, 32
    arrs = arrays(8, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd)) + [np.full(s, -1, np.int32)]
    got = ops.decode_attention(*to_torch(arrs, "float32"))
    assert torch.equal(got, torch.zeros_like(got))
    want = pallas_decode(*to_jax(arrs, "float32"), block_k=16, interpret=True)
    assert np.array_equal(f32(want), np.zeros_like(f32(want)))


# ------------------------------------------------ the wrappers off the card
def test_cpu_wrappers_take_the_plain_versions_and_count_no_launch():
    fq = to_torch(arrays(9, (1, 2, 16, 32), (1, 2, 16, 32), (1, 2, 16, 32)), "float32")
    dq = to_torch(arrays(9, (1, 2, 32), (1, 8, 2, 32), (1, 8, 2, 32))
                  + [decode_pos(8, 5)], "float32")
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    assert torch.equal(ops.flash_attention(*fq, q_offset=0), fa.flash_attention_plain(*fq))
    assert torch.equal(ops.decode_attention(*dq), da.decode_attention_plain(*dq))
    assert (fa.flash_attention.launches, da.decode_attention.launches) == before


def _flash_good():
    return to_torch(arrays(10, (1, 4, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32)), "float32")


def _decode_good():
    return to_torch(arrays(10, (1, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32))
                    + [decode_pos(8, 4)], "float32")


FLASH_BAD = {
    "head_dim_96": lambda a: [t.repeat(1, 1, 1, 3) for t in a],
    "heads_not_a_multiple": lambda a: [a[0][:, :3].contiguous(), a[1], a[2]],
    "k_v_differ": lambda a: [a[0], a[1], a[2][:, :, :4].contiguous()],
    "batch_differs": lambda a: [a[0], a[1].repeat(2, 1, 1, 1), a[2].repeat(2, 1, 1, 1)],
    "half": lambda a: [x.half() for x in a],
    "mixed_dtype": lambda a: [a[0].bfloat16(), a[1], a[2]],
    "not_contiguous": lambda a: [a[0].transpose(2, 3).contiguous().transpose(2, 3), a[1], a[2]],
    "three_dims": lambda a: [a[0][0], a[1], a[2]],
}
FLASH_EXC = {"half": TypeError, "mixed_dtype": TypeError}


@pytest.mark.parametrize("name", sorted(FLASH_BAD))
def test_flash_wrapper_raises_before_any_launch(name):
    """What the CUDA kernel cannot address raises in the wrapper for a
    tensor on any device (head_dim 96 included, which the plain version
    could compute), instead of giving way to the plain version."""
    args = FLASH_BAD[name](_flash_good())
    exc = FLASH_EXC.get(name, ValueError)
    with pytest.raises(exc):
        fa.check_args(*args, window=0, q_offset=0)
    with pytest.raises(exc):
        ops.flash_attention(*args)


def test_flash_head_dim_check_is_the_kernels():
    q, k, v = to_torch(arrays(11, (1, 2, 8, 96), (1, 2, 8, 96), (1, 2, 8, 96)), "float32")
    fa.flash_attention_plain(q, k, v)            # the arithmetic itself is fine
    with pytest.raises(ValueError, match="head_dim 96"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="must be >= 0"):
        ops.flash_attention(*_flash_good(), window=-1)


DECODE_BAD = {
    "pos_int64": (lambda a: a[:3] + [a[3].long()], TypeError),
    "pos_length": (lambda a: a[:3] + [a[3][:4]], ValueError),
    "head_dim_24": (lambda a: [x[..., :24].contiguous() for x in a[:3]] + [a[3]], ValueError),
    "caches_differ": (lambda a: [a[0], a[1], a[2][:, :4].contiguous(), a[3]], ValueError),
    "half": (lambda a: [x.half() for x in a[:3]] + [a[3]], TypeError),
    "cache_layout": (lambda a: [a[0], a[1].transpose(1, 2).contiguous().transpose(1, 2),
                                a[2], a[3]], ValueError),
}


@pytest.mark.parametrize("name", sorted(DECODE_BAD))
def test_decode_wrapper_raises_before_any_launch(name):
    breaker, exc = DECODE_BAD[name]
    args = breaker(_decode_good())
    with pytest.raises(exc):
        da.check_args(*args)
    with pytest.raises(exc):
        ops.decode_attention(*args)


@pytest.mark.parametrize("module", ["flash_attention", "decode_attention"])
def test_wrappers_have_no_fallback_from_the_kernel(module):
    """Source-level guard: no ``try`` in the wrapper, and the plain version is
    reached only behind the device check."""
    tree = ast.parse((SRC / "kernels" / f"{module}.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == module)
    assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)]
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == f"{module}_plain"]
    assert len(calls) == 1
    guard = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                 and calls[0] in ast.walk(n))
    assert "cpu" in ast.unparse(guard.test)


def test_kernel_sources_are_built_together():
    from repro_torch.kernels import _build
    assert _build.sources() == ["decode_attention", "flash_attention", "paged_attention"]


# ------------------------------------------------------------------ bounds
@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (16, 16, True, 0, 0), (8, 24, True, 0, 16), (16, 16, True, 5, 0),
    (8, 20, False, 0, 0), (8, 20, False, 6, 10), (4, 4, True, 0, 9)])
def test_live_pairs_count_the_mask(sq, sk, causal, window, q_offset):
    mask = fa.attention_mask(sq, sk, causal=causal, window=window, q_offset=q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert fa.live_pairs(sq, sk, **kw) == int(mask.sum())
    assert fa.needed_keys(sq, sk, **kw) == int(mask.any(0).sum())


def test_bounds():
    # causal B 1, S 2048, H 32, hd 64 in bf16: operations bind
    pairs = 2048 * 2049 // 2
    ms, by = fa.bound_ms(1, 32, 32, 2048, 2048, 64, torch.bfloat16, causal=True)
    assert by == "operations" and ms == pytest.approx(1e3 * 4 * 64 * 32 * pairs / 989e12)
    # a short suffix over a long prefix: bytes bind
    ms, by = fa.bound_ms(32, 32, 32, 1, 4096, 64, torch.bfloat16, causal=True, q_offset=4095)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 2 * 64 * (2 * 32 * 32 + 2 * 32 * 32 * 4096) / 3.35e12)
    # decode: the K and V rows of the valid slots, q, out and pos
    assert da.live_bytes(600, 32, 32, 8, 1024, 128, 2) == (
        2 * 128 * (2 * 600 * 32 * 8 + 2 * 32 * 32) + 4 * 1024)
    assert da.bound_ms(600, 32, 32, 8, 1024, 128, 2) == pytest.approx(
        1e3 * da.live_bytes(600, 32, 32, 8, 1024, 128, 2) / 3.35e12)
