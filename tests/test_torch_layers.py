"""repro_torch.models.layers against repro.models.layers: the same numpy
inputs through both, fp32 at 1e-5 (summation order), bf16 at 3e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]


def rnd(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def j(x, dtype="float32"):
    return jnp.asarray(x, JDT[dtype])


def t(x, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(TDT[dtype])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, dtype, scale=1.0):
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL[dtype] * scale,
                               rtol=ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    x, s = rnd(0, 3, 5, 64) * 3, rnd(1, 64) * 0.1
    got = TL.rms_norm(t(x, dtype), t(s), 1e-5)
    assert got.dtype == TDT[dtype]
    close(got, JL.rms_norm(j(x, dtype), j(s), 1e-5), dtype)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_angles(theta):
    pos = np.stack([np.arange(0, 4096, 37), np.arange(5, 4101, 37)]).astype(np.int32)
    got = TL.rope_angles(torch.from_numpy(pos), 64, theta)
    want = JL.rope_angles(jnp.asarray(pos), 64, theta)
    assert got.shape == (2, pos.shape[1], 32) and got.dtype == torch.float32
    # theta ** x differs by an ulp between the libraries, times positions <= 4100
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-4, rtol=1e-6)


def test_rope_angles_refuses_mrope():
    """(3, B, S) positions need M-RoPE sections, as the reference asserts;
    with them they are M-RoPE (test_torch_archs.py)."""
    with pytest.raises(ValueError, match="M-RoPE"):
        TL.rope_angles(torch.zeros((3, 2, 4), dtype=torch.int32), 16, 1e4)
    with pytest.raises(ValueError, match="M-RoPE"):
        TL.rope_angles(torch.zeros((2, 3, 2, 4), dtype=torch.int32), 16, 1e4, (2, 3, 3))


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(dtype):
    x = rnd(2, 2, 7, 4, 16)
    ang = (np.arange(7, dtype=np.float32)[None, :, None]
           * (1.0 / 10_000.0 ** (np.arange(8, dtype=np.float32) / 8)))
    ang = np.broadcast_to(ang, (2, 7, 8)).copy()
    got = TL.apply_rope(t(x, dtype), t(ang))
    assert got.dtype == TDT[dtype]
    close(got, JL.apply_rope(j(x, dtype), j(ang)), dtype)


def _attn_inputs(seed, b, sq, sk, h, kv, hd):
    return rnd(seed, b, sq, h, hd), rnd(seed + 1, b, sk, kv, hd), rnd(seed + 2, b, sk, kv, hd)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", ["gqa_attention", "gqa_attention_bf16"])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_gqa_attention_causal(fn, dtype, q_offset):
    sq, sk = 6, 6 + q_offset
    q, k, v = _attn_inputs(3, 2, sq, sk, 4, 2, 16)
    got = getattr(TL, fn)(t(q, dtype), t(k, dtype), t(v, dtype),
                          TL.causal_mask(sq, sk, q_offset=q_offset))
    want = getattr(JL, fn)(j(q, dtype), j(k, dtype), j(v, dtype),
                           JL.causal_mask(sq, sk, q_offset=q_offset))
    assert got.shape == (2, sq, 4, 16) and got.dtype == TDT[dtype]
    close(got, want, dtype)


@pytest.mark.parametrize("sq,sk,window,q_offset", [(4, 4, 0, 0), (3, 8, 0, 5), (5, 5, 2, 0)])
def test_masks(sq, sk, window, q_offset):
    got = TL.causal_mask(sq, sk, window, q_offset)
    want = JL.causal_mask(sq, sk, window, q_offset)
    assert got.dtype == torch.bool and (got.numpy() == np.asarray(want)).all()
    assert (TL.full_mask(sq, sk).numpy() == np.asarray(JL.full_mask(sq, sk))).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu(dtype):
    x, wg, wu, wd = rnd(4, 2, 3, 32), rnd(5, 32, 48) / 6, rnd(6, 32, 48) / 6, rnd(7, 48, 32) / 7
    got = TL.swiglu(*(t(a, dtype) for a in (x, wg, wu, wd)))
    close(got, JL.swiglu(*(j(a, dtype) for a in (x, wg, wu, wd))), dtype)


def test_dtype_of():
    assert TL.dtype_of("bfloat16") is torch.bfloat16
    assert TL.dtype_of("float32") is torch.float32


# ------------------------------------------------------------------ KV cache
@pytest.mark.parametrize("reserve", [0, 3])
def test_kv_cache_from_prefill_update_and_mask(reserve):
    k, v = rnd(8, 2, 5, 2, 8), rnd(9, 2, 5, 2, 8)
    kn, vn = rnd(10, 2, 1, 2, 8), rnd(11, 2, 1, 2, 8)
    jc = JL.KVCache.from_prefill(j(k), j(v), 0, reserve)
    tc = TL.KVCache.from_prefill(t(k), t(v), 0, reserve)
    for a, b in zip(tc, jc):
        assert (f32(a) == f32(b)).all() and a.shape == b.shape
    assert tc.pos.dtype == torch.int32
    if reserve:
        jc = jc.update(j(kn), j(vn), jnp.int32(5))
        tc2 = tc.update(t(kn), t(vn), 5)
        assert tc2 is tc                      # updated in place
        for a, b in zip(tc, jc):
            assert (f32(a) == f32(b)).all()
    assert (tc.decode_mask().numpy() == np.asarray(jc.decode_mask())).all()


def test_kv_cache_init_and_window_refusal():
    """``from_prefill`` against the reference for S = 6: no window, windows
    that wrap the ring (3, 4), one that fits exactly (6) and one with empty
    slots after the prefix (9); then a decode step into the ring.  What the
    reference refuses is refused: continued prefill over a windowed kind's
    ring."""
    c = TL.KVCache.init(2, 6, 2, 8, torch.bfloat16)
    jc = JL.KVCache.init(2, 6, 2, 8, jnp.bfloat16)
    assert c.k.shape == jc.k.shape and c.k.dtype == torch.bfloat16
    assert (c.pos.numpy() == np.asarray(jc.pos)).all()
    k, v = rnd(0, 2, 6, 2, 8), rnd(1, 2, 6, 2, 8)
    kn, vn = rnd(2, 2, 1, 2, 8), rnd(3, 2, 1, 2, 8)
    for window in (0, 3, 4, 6, 9):
        tc = TL.KVCache.from_prefill(t(k), t(v), window=window, reserve=2)
        jc = JL.KVCache.from_prefill(j(k), j(v), window, 2)
        for a, b in zip(tc, jc):
            assert a.shape == b.shape and (f32(a) == f32(b)).all(), window
        assert tc.pos.dtype == torch.int32
        tc = tc.update(t(kn), t(vn), 6)
        jc = jc.update(j(kn), j(vn), jnp.int32(6))
        for a, b in zip(tc, jc):
            assert (f32(a) == f32(b)).all(), window
    from repro_torch.configs import get_reduced
    from repro_torch.models import blocks as TB
    cfg = get_reduced("mixtral-8x7b")
    p = TB.init_block(torch.Generator().manual_seed(0), "moe_swa", cfg, "cpu")
    with pytest.raises(NotImplementedError, match="'moe_swa'"):
        TB.apply_block("moe_swa", cfg, p, torch.zeros(1, 1, cfg.d_model), {}, tc,
                       "prefill_cont")


# --------------------------------------------------------------- paged decode
def _step_case(seed, b, h, kvh, hd, bs, nb, maxb):
    """One decode step's inputs (as tests/test_paged_kernel.py builds them)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k_new, v_new = f(b, 1, h, hd), f(b, 1, kvh, hd), f(b, 1, kvh, hd)
    pk, pv = f(nb, bs, kvh, hd), f(nb, bs, kvh, hd)
    positions = rng.integers(0, maxb * bs, size=b).astype(np.int32)
    tables = np.zeros((b, maxb), np.int32)
    for r in range(b):
        need = int(positions[r]) // bs + 1
        tables[r, :need] = rng.choice(np.arange(1, nb), size=need, replace=False)
    return (q, k_new, v_new), (pk, pv), tables, positions


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,kvh,hd,bs,nb,maxb",
                         [(3, 4, 2, 8, 4, 16, 3), (2, 8, 8, 16, 8, 12, 2),
                          (5, 6, 3, 8, 16, 24, 4)])
def test_paged_decode_attention_dense(b, h, kvh, hd, bs, nb, maxb, dtype):
    qkv, pool, tables, positions = _step_case(0, b, h, kvh, hd, bs, nb, maxb)
    jout, jpool = JL.paged_decode_attention_dense(
        tuple(j(a, dtype) for a in qkv), JL.PagedKV(*(j(a, dtype) for a in pool)),
        jnp.asarray(tables), jnp.asarray(positions), bs)
    tpool = TL.PagedKV(*(t(a, dtype) for a in pool))
    tout, tpool2 = TL.paged_decode_attention_dense(
        tuple(t(a, dtype) for a in qkv), tpool, torch.from_numpy(tables),
        torch.from_numpy(positions), bs)
    assert tpool2.k is tpool.k                 # the arena is written in place
    assert (f32(tpool.k) == f32(jpool.k)).all()     # identical arena writes
    assert (f32(tpool.v) == f32(jpool.v)).all()
    close(tout, jout, dtype)


def test_paged_write_index():
    tables = torch.tensor([[3, 7, 0], [5, 0, 0]], dtype=torch.int32)
    blk, slot = TL.paged_write_index(tables, torch.tensor([9, 2], dtype=torch.int32), 8)
    assert blk.tolist() == [7, 5] and slot.tolist() == [1, 2]
    assert blk.dtype == slot.dtype == torch.int64


def test_qchunk_is_refused():
    """``attn_impl="qchunk"`` runs a monolithic prefill (test_torch_archs.py)
    and is refused by the continued prefill over cached KV, whose blocked
    softmax would sum in another order, as in the reference."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_reduced("phi4-mini-3.8b"), attn_impl="qchunk")
    lm = LM(cfg, device="cpu")
    with torch.inference_mode():
        logits, caches = lm.prefill({"tokens": torch.zeros((1, 4), dtype=torch.int32)})
        assert logits.shape == (1, cfg.vocab_size) and torch.isfinite(logits).all()
        with pytest.raises(NotImplementedError, match="qchunk"):
            lm.prefill_cont(caches, {"tokens": torch.zeros((1, 2), dtype=torch.int32)})
