"""repro_torch.models (blocks + LM) against repro.models with the reference's
weights loaded through ``from_jax_params``: prefill, continued prefill over a
cached prefix, ring decode and paged decode in both implementations.

fp32: logits at 1e-4 (summation order of the matrix products) and equal
greedy tokens.  bf16: the two frameworks round at different places, so logits
are held to the engine's PAGED_KERNEL_RTOL/ATOL-sized bound."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.models import LM as JLM
from repro.models.layers import KVCache as JKVCache
from repro.serving import KVBlockPool as JPool
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import from_jax_params, to_tensor
from repro_torch.models import LM, ModelConfig
from repro_torch.models import blocks as TB
from repro_torch.models.layers import KVCache, PagedKV
from repro_torch.serving import KVBlockPool
from repro_torch.serving.engine import PAGED_KERNEL_ATOL, PAGED_KERNEL_RTOL

ARCHS = ["stablelm-1.6b", "llama3-8b", "phi4-mini-3.8b"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=PAGED_KERNEL_ATOL, rtol=PAGED_KERNEL_RTOL)}
BS = 8


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    jcfg = dataclasses.replace(jget(arch), dtype=dtype)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    lm = from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return dtype, jlm, params, lm


def tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def check_logits(got, want, dtype):
    got, want = f32(got), f32(want)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    if dtype == "float32":
        assert agree == 1.0
    return agree


def copy_arenas(jarenas, pool: KVBlockPool) -> None:
    """Copy a reference arena into the port's pool, bit for bit."""
    for src, dst in zip(jarenas, pool.arenas):
        dst.k.copy_(to_tensor(np.asarray(src.k)))
        dst.v.copy_(to_tensor(np.asarray(src.v)))


def test_configs_equal_the_reference_field_by_field():
    from repro.configs import get_config as jfull
    from repro.configs import list_archs as jlist
    from repro_torch.configs import list_archs
    assert list_archs() == jlist()
    for arch in ARCHS + ["mixtral-8x7b", "mixtral-8x22b", "hymba-1.5b", "xlstm-1.3b",
                         "minicpm-2b", "qwen2-vl-7b", "seamless-m4t-medium"]:
        assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(jget(arch))
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jfull(arch))
    assert isinstance(get_reduced("llama3-8b"), ModelConfig)
    with pytest.raises(KeyError, match="gpt-5"):       # as the reference's lookup
        get_config("gpt-5")


@torch.inference_mode()
def test_prefill_and_decode_step(pair):
    dtype, jlm, params, lm = pair
    toks = tokens(0, 3, 16)
    jl, jc = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, reserve=4)
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks)}, reserve=4)
    check_logits(tl, jl, dtype)
    assert tc[0].k.shape == jc[0].k.shape
    assert (tc[0].pos.numpy() == np.asarray(jc[0].pos)).all()
    np.testing.assert_allclose(f32(tc[0].k), f32(jc[0].k), **TOL[dtype])
    cur = f32(jl).argmax(-1).astype(np.int32)[:, None]
    for step in range(3):
        jl, jc = jlm.decode_step(params, jc, jnp.asarray(cur), jnp.int32(16 + step))
        tl, tc2 = lm.decode_step(tc, torch.from_numpy(cur), 16 + step)
        assert tc2[0].k is tc[0].k            # ring cache updated in place
        check_logits(tl, jl, dtype)
        cur = f32(jl).argmax(-1).astype(np.int32)[:, None]
    assert (tc[0].pos.numpy() == np.asarray(jc[0].pos)).all()


@torch.inference_mode()
def test_prefill_cont_over_cached_prefix(pair):
    dtype, jlm, params, lm = pair
    prefix, suffix = tokens(1, 1, 11), tokens(2, 3, 5)
    _, jpc = jlm.prefill(params, {"tokens": jnp.asarray(prefix)})
    _, tpc = lm.prefill({"tokens": torch.from_numpy(prefix)})
    jl, jc = jlm.prefill_cont(params, jpc, {"tokens": jnp.asarray(suffix)})
    tl, tc = lm.prefill_cont(tpc, {"tokens": torch.from_numpy(suffix)})
    check_logits(tl, jl, dtype)
    assert tc[0].k.shape == jc[0].k.shape == (2, 3, 16) + tc[0].k.shape[3:]
    # inside the port: the batch-1 prefix broadcast + suffix equals the
    # monolithic prefill of the concatenated rows
    full = np.concatenate([np.repeat(prefix, 3, 0), suffix], axis=1)
    ml, mc = lm.prefill({"tokens": torch.from_numpy(full)})
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(f32(tl), f32(ml), **tol)
    np.testing.assert_allclose(f32(tc[0].k), f32(mc[0].k), **tol)


@torch.inference_mode()
@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_decode_step_paged(pair, impl):
    """Identical pools on both sides (the reference's arena copied into the
    port's), then one paged decode step per row at its own position."""
    dtype, jlm, params, lm = pair
    s, b = 13, 3
    toks = tokens(3, b, s)
    _, jc = jlm.prefill(params, {"tokens": jnp.asarray(toks)})
    jpool = JPool(jlm, num_blocks=24, block_size=BS)
    tpool = KVBlockPool(lm, num_blocks=24, block_size=BS, device="cpu")
    rows = [jpool.alloc(3) for _ in range(b)]
    assert rows == [tpool.alloc(3) for _ in range(b)]
    jpool.write(jc, [r[:2] for r in rows])
    copy_arenas(jpool.arenas, tpool)
    tables = np.zeros((4, 4), np.int32)            # one bucket-dummy row
    for r, run in enumerate(rows):
        tables[r, :3] = run
    positions = np.array([s, s, s, 0], np.int32)
    cur = np.array([[5], [77], [200], [256]], np.int32)
    for step in range(4):                          # crosses a block boundary
        jl, jar = jlm.decode_step_paged(
            params, jpool.arenas, jnp.asarray(cur), jnp.asarray(positions),
            jnp.asarray(tables), block_size=BS, impl=impl)
        jpool.arenas = jar
        tl, tar = lm.decode_step_paged(
            tpool.arenas, torch.from_numpy(cur), torch.from_numpy(positions),
            torch.from_numpy(tables), block_size=BS, impl=impl)
        assert tar[0].k is tpool.arenas[0].k       # arena written in place
        check_logits(tl[:b], jl[:b], dtype)
        np.testing.assert_allclose(f32(tar[0].k[:, 1:]), f32(jar[0].k[:, 1:]),
                                   **TOL[dtype])
        cur[:b, 0] = f32(jl).argmax(-1)[:b]
        positions[:b] += 1


@torch.inference_mode()
def test_paged_dense_step_equals_ring_decode_step(pair):
    """Inside the port: a paged dense step per row equals the ring
    ``decode_step`` over a cache holding the same tokens."""
    dtype, _, _, lm = pair
    s, b = 16, 2
    toks = tokens(4, b, s)
    logits, ring = lm.prefill({"tokens": torch.from_numpy(toks)}, reserve=3)
    _, exact = lm.prefill({"tokens": torch.from_numpy(toks)})
    pool = KVBlockPool(lm, num_blocks=12, block_size=BS, device="cpu")
    rows = [pool.alloc(3) for _ in range(b)]
    pool.write(exact, [r[:2] for r in rows])
    tables = torch.tensor(rows, dtype=torch.int32)
    cur = logits.argmax(-1)[:, None]
    for step in range(3):
        rl, ring = lm.decode_step(ring, cur, s + step)
        pl_, _ = lm.decode_step_paged(
            pool.arenas, cur, torch.full((b,), s + step, dtype=torch.int32),
            tables, block_size=BS)
        tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else TOL[dtype]
        np.testing.assert_allclose(f32(pl_), f32(rl), **tol)
        assert (pl_.argmax(-1) == rl.argmax(-1)).all() or dtype == "bfloat16"
        cur = rl.argmax(-1)[:, None]


@torch.inference_mode()
def test_score_hidden_and_forward(pair):
    dtype, jlm, params, lm = pair
    toks = tokens(5, 2, 12)
    got = lm.score_hidden({"tokens": torch.from_numpy(toks)})
    want = jlm.score_hidden(params, {"tokens": jnp.asarray(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


# ------------------------------------------------------------ blocks, directly
@torch.inference_mode()
@pytest.mark.parametrize("mode", ["train", "prefill", "decode", "prefill_cont",
                                  "decode_paged"])
def test_apply_stack_modes_against_reference(mode):
    """blocks.apply_stack in each of the five modes, fp32, weights from
    numpy."""
    from repro.models import blocks as JB
    cfg = dataclasses.replace(get_reduced("llama3-8b"), dtype="float32")
    jcfg = dataclasses.replace(jget("llama3-8b"), dtype="float32")
    rng = np.random.default_rng(6)
    n, d, kv, hd = 2, cfg.d_model, cfg.n_kv_heads, cfg.hd
    jstack = JB.init_stack(jax.random.PRNGKey(1), "attn", n, jcfg)
    tstack = jax.tree.map(lambda a: to_tensor(np.asarray(a)), jstack)
    b, s = 2, (1 if mode.startswith("decode") else 6)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    cached = 8
    ck = rng.standard_normal((n, b, cached, kv, hd)).astype(np.float32)
    cv = rng.standard_normal((n, b, cached, kv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(cached, dtype=np.int32), (n, cached)).copy()
    start = cached if mode in ("prefill_cont", "decode") else 0
    positions = np.broadcast_to(start + np.arange(s, dtype=np.int32), (b, s))
    from repro.models.layers import rope_angles as jrope
    from repro_torch.models.layers import rope_angles as trope
    jctx = {"angles": jrope(jnp.asarray(positions), hd, cfg.rope_theta), "reserve": 0}
    tctx = {"angles": trope(torch.from_numpy(positions.copy()), hd, cfg.rope_theta),
            "reserve": 0}
    jcache = tcache = None
    if mode == "prefill_cont":
        jcache = JKVCache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos))
        tcache = KVCache(torch.from_numpy(ck), torch.from_numpy(cv), torch.from_numpy(pos))
    elif mode == "decode":
        pad = lambda a: np.pad(a, ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0)))
        pos2 = np.pad(pos, ((0, 0), (0, 2)), constant_values=-1)
        jcache = JKVCache(jnp.asarray(pad(ck)), jnp.asarray(pad(cv)), jnp.asarray(pos2))
        tcache = KVCache(torch.from_numpy(pad(ck)), torch.from_numpy(pad(cv)),
                         torch.from_numpy(pos2))
        jctx["position"], tctx["position"] = jnp.int32(cached), cached
    elif mode == "decode_paged":
        from repro.models.layers import PagedKV as JPagedKV
        pk = rng.standard_normal((n, 6, 4, kv, hd)).astype(np.float32)
        pv = rng.standard_normal((n, 6, 4, kv, hd)).astype(np.float32)
        tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
        ppos = np.array([9, 6], np.int32)
        ang_pos = ppos[:, None]
        jctx.update(angles=jrope(jnp.asarray(ang_pos), hd, cfg.rope_theta),
                    paged_tables=jnp.asarray(tables), paged_positions=jnp.asarray(ppos),
                    paged_block_size=4)
        tctx.update(angles=trope(torch.from_numpy(ang_pos.copy()), hd, cfg.rope_theta),
                    paged_tables=torch.from_numpy(tables),
                    paged_positions=torch.from_numpy(ppos), paged_block_size=4)
        jcache = JPagedKV(jnp.asarray(pk), jnp.asarray(pv))
        tcache = PagedKV(torch.from_numpy(pk), torch.from_numpy(pv))
    jx, jc = JB.apply_stack("attn", jcfg, jstack, jnp.asarray(x), jctx, jcache, mode)
    tx, tc = TB.apply_stack("attn", cfg, tstack, torch.from_numpy(x), tctx, tcache, mode)
    np.testing.assert_allclose(f32(tx), f32(jx), atol=1e-4, rtol=1e-4)
    if mode == "train":
        assert tc is None
    else:
        for a, c in zip(tc, jc):
            assert a.shape == c.shape
            np.testing.assert_allclose(f32(a), f32(c), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["swa", "moe", "moe_swa", "hymba_g", "hymba_l",
                                  "mlstm", "slstm", "enc", "xdec"])
def test_other_block_kinds_raise_by_name(kind):
    """Every other kind builds, and refuses the prefix-KV and paged modes by
    name, as the reference's ``apply_block`` does (``enc`` and ``xdec`` with
    ``xdec``'s cross K / V over 5 encoder positions)."""
    cfg = get_reduced({"moe": "mixtral-8x7b", "moe_swa": "mixtral-8x7b",
                       "hymba_g": "hymba-1.5b", "hymba_l": "hymba-1.5b",
                       "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b",
                       "enc": "seamless-m4t-medium",
                       "xdec": "seamless-m4t-medium"}.get(kind, "llama3-8b"))
    x = torch.zeros(1, 1, cfg.d_model)
    p = TB.init_block(torch.Generator().manual_seed(0), kind, cfg, "cpu")
    cache = TB.init_block_cache(kind, cfg, 1, 8, enc_len=5, device="cpu")
    if kind == "enc":
        assert cache == ()
    if kind == "xdec":
        assert {"x_wq", "x_wk", "x_wv", "x_wo"} <= set(p) and p["norm_x"].dtype == torch.float32
        assert cache[1].shape == cache[2].shape == (1, 5, cfg.n_kv_heads, cfg.hd)
    for mode in ("prefill_cont", "decode_paged"):
        with pytest.raises(NotImplementedError, match=f"{mode}.*'{kind}'"):
            TB.apply_block(kind, cfg, p, x, {}, cache, mode)


def test_qchunk_and_unported_model_features_raise():
    """What the reference refuses, the port refuses: ``qchunk`` in the
    continued prefill, embeds input and M-RoPE in the paged decode step."""
    cfg = dataclasses.replace(get_reduced("llama3-8b"), attn_impl="qchunk")
    lm = LM(cfg, device="cpu")
    with torch.inference_mode():
        _, caches = lm.prefill({"tokens": torch.zeros((1, 4), dtype=torch.int32)})
        with pytest.raises(NotImplementedError, match="qchunk"):
            lm.prefill_cont(caches, {"tokens": torch.zeros((1, 2), dtype=torch.int32)})
    # LM.loss came with the training slice: a finite scalar on a reduced batch
    loss, aux = LM(get_reduced("llama3-8b"), device="cpu").loss(
        {"tokens": torch.zeros((2, 5), dtype=torch.int32)})
    assert loss.dim() == 0 and torch.isfinite(loss) and float(aux["tokens"]) == 8
    for arch in ("qwen2-vl-7b",
                 dataclasses.replace(get_reduced("llama3-8b"), mrope_sections=(2, 3, 3))):
        cfg = get_reduced(arch) if isinstance(arch, str) else arch
        m = LM(cfg, device="cpu")
        with pytest.raises(ValueError, match="M-RoPE"), torch.inference_mode():
            m.decode_step_paged([], torch.zeros((1, 1), dtype=torch.int32),
                                torch.zeros((1,), dtype=torch.int32),
                                torch.ones((1, 1), dtype=torch.int32), block_size=8)


def test_device_rule_and_seeded_init():
    cfg = get_reduced("stablelm-1.6b")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LM(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KVBlockPool(LM(cfg, device="cpu"), 4)
    a = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.embed, b.embed) and not torch.equal(a.embed, c.embed)
    assert a.embed.dtype == torch.bfloat16 and a.final_norm.dtype == torch.float32
    assert a.stacks[0]["wq"].shape == (2, cfg.d_model, cfg.n_heads * cfg.hd)
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count()


def test_bf16_conversion_is_bit_exact():
    x = jnp.asarray(np.random.default_rng(7).standard_normal((5, 7)), jnp.bfloat16)
    arr = np.asarray(x)
    assert arr.dtype.name == "bfloat16"
    got = to_tensor(arr)
    assert got.dtype == torch.bfloat16
    assert (got.view(torch.int16).numpy() == arr.view(np.int16)).all()
