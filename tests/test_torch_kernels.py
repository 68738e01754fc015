"""repro_torch paged decode attention: the plain PyTorch version against the
reference's Pallas kernel (interpret mode off-TPU) and its jnp oracle, and the
CUDA wrapper's argument checks (which run before any launch, so they are
testable without a GPU)."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops, paged_attention as pa

SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"

# (b, h, kv, hd, bs, nb, maxb): the reference's two sweeps, the two
# full-width head shapes (hd 64 / G 1, hd 128 / G 4), block_size 1, G 8
SWEEP = [(2, 4, 2, 16, 8, 9, 2), (3, 8, 2, 32, 16, 13, 3), (1, 4, 4, 16, 8, 5, 4),
         (3, 4, 2, 8, 4, 16, 3), (2, 8, 8, 16, 8, 12, 2), (5, 6, 3, 8, 16, 24, 4),
         (2, 4, 4, 64, 16, 9, 3), (2, 8, 2, 128, 16, 9, 3),
         (3, 4, 2, 16, 1, 40, 9), (2, 16, 2, 32, 5, 20, 7)]
# fp32: summation order only; bf16: the reference's own tolerance
TOL = {"float32": dict(atol=2e-5, rtol=0), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def paged_case(seed, b, h, kv, hd, bs, nb, maxb):
    """numpy inputs: a pool full of values (unused slots are stale, not
    zero), distinct non-dummy blocks per row, 0-padded tables, ragged ctx."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    ids = rng.permutation(np.arange(1, nb))[: b * maxb].reshape(b, maxb)
    n_blk = rng.integers(1, maxb + 1, size=b)
    tables = np.where(np.arange(maxb)[None, :] < n_blk[:, None], ids, 0)
    ctx = (n_blk - 1) * bs + rng.integers(1, bs + 1, size=b)
    return q, kp, vp, tables.astype(np.int32), ctx.astype(np.int32)


def both(case, dtype):
    q, kp, vp, tables, ctx = case
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(tables), jnp.asarray(ctx))
    targs = (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
             torch.from_numpy(vp).to(tdt), torch.from_numpy(tables),
             torch.from_numpy(ctx))
    return jargs, targs


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "-".join(map(str, s)))
def test_plain_matches_reference_kernel_and_oracle(shape, dtype):
    jargs, targs = both(paged_case(0, *shape), dtype)
    got = f32(pa.paged_attention_plain(*targs))
    np.testing.assert_allclose(got, f32(jref.paged_decode_attention_ref(*jargs)),
                               **TOL[dtype])
    np.testing.assert_allclose(got, f32(jops.paged_decode_attention(*jargs)),
                               **TOL[dtype])


@pytest.mark.parametrize("shape", SWEEP[:4], ids=lambda s: "-".join(map(str, s)))
def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch(shape):
    _, targs = both(paged_case(1, *shape), "float32")
    before = pa.paged_attention.launches
    out = ops.paged_decode_attention(*targs)
    assert torch.equal(out, pa.paged_attention_plain(*targs))
    assert pa.paged_attention.launches == before


def test_stale_and_nonfinite_values_beyond_ctx_do_not_reach_the_result():
    """Freed blocks are reused without being cleared: whatever lies at
    positions >= ctx_len, in padded table slots and in dummy block 0 must get
    weight exactly 0."""
    shape = (3, 4, 2, 16, 8, 12, 3)
    q, kp, vp, tables, ctx = paged_case(2, *shape)
    _, clean = both((q, kp, vp, tables, ctx), "float32")
    want = pa.paged_attention_plain(*clean)
    kp2, vp2 = kp.copy(), vp.copy()
    bs = shape[4]
    live = np.zeros(kp.shape[:2], bool)
    for r in range(shape[0]):
        for p in range(int(ctx[r])):
            live[tables[r, p // bs], p % bs] = True
    kp2[~live] = 1e30
    vp2[~live] = np.inf
    _, dirty = both((q, kp2, vp2, tables, ctx), "float32")
    assert torch.equal(pa.paged_attention_plain(*dirty), want)


def test_dummy_row_reads_block_zero():
    """A bucket-dummy row: all-zero table, ctx_len 1."""
    q, kp, vp, tables, ctx = paged_case(3, 2, 4, 2, 16, 8, 9, 2)
    tables[1] = 0
    ctx[1] = 1
    _, targs = both((q, kp, vp, tables, ctx), "float32")
    out = pa.paged_attention_plain(*targs)
    # one valid token: the softmax weight is 1 and the output is its V row
    want = torch.from_numpy(vp[0, 0]).repeat_interleave(2, dim=0)
    torch.testing.assert_close(out[1], want, atol=1e-6, rtol=0)


# ------------------------------------------------ the wrapper's argument checks
def _good():
    _, targs = both(paged_case(4, 2, 4, 2, 16, 8, 9, 2), "float32")
    return list(targs)


def test_check_args_accepts_the_engine_layout():
    pa.check_args(*_good())
    # a per-layer view of a stacked arena is contiguous: taken without a copy
    q, kp, vp, tables, ctx = _good()
    arena_k, arena_v = torch.stack([kp, kp]), torch.stack([vp, vp])
    pa.check_args(q, arena_k[1], arena_v[1], tables, ctx)


def _bad_hd(a):
    a[0], a[1], a[2] = a[0][..., :12], a[1][..., :12].contiguous(), a[2][..., :12].contiguous()
    a[0] = a[0].contiguous()


def _bad_noncontig_pool(a):
    a[1] = a[1].transpose(1, 2).contiguous().transpose(1, 2)


def _bad_table_dtype(a):
    a[3] = a[3].long()


def _bad_ctx_shape(a):
    a[4] = a[4][:1]


def _bad_dtype(a):
    a[0], a[1], a[2] = a[0].half(), a[1].half(), a[2].half()


def _bad_mixed_dtype(a):
    a[0] = a[0].bfloat16()


def _bad_heads(a):
    a[0] = a[0][:, :3].contiguous()


def _bad_v_shape(a):
    a[2] = a[2][:-1]


@pytest.mark.parametrize("breaker,exc", [
    (_bad_hd, ValueError), (_bad_noncontig_pool, ValueError),
    (_bad_table_dtype, TypeError), (_bad_ctx_shape, ValueError),
    (_bad_dtype, TypeError), (_bad_mixed_dtype, TypeError),
    (_bad_heads, ValueError), (_bad_v_shape, ValueError)],
    ids=lambda x: getattr(x, "__name__", ""))
def test_wrapper_raises_before_any_launch(breaker, exc):
    """What the CUDA kernel cannot address raises in the wrapper, for a
    tensor on any device, instead of giving way to the plain version."""
    args = _good()
    breaker(args)
    with pytest.raises(exc):
        pa.check_args(*args)
    with pytest.raises(exc):
        pa.paged_attention(*args)


def test_wrapper_has_no_fallback_from_the_kernel():
    """Source-level guard: the wrapper contains no ``try`` (a failed build or
    launch must surface), and reaches the plain version only behind the
    device check."""
    tree = ast.parse((SRC / "kernels" / "paged_attention.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "paged_attention")
    assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)]
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "paged_attention_plain"]
    assert len(calls) == 1
    guard = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                 and calls[0] in ast.walk(n))
    assert "cpu" in ast.unparse(guard.test)


def test_bound_counts_live_blocks_only():
    """The bound counts what the rows need: the K and V rows of the valid
    tokens (not a block's invalid tail), q and the output, the live table
    entries and ``ctx_len``."""
    ctx = [1, 16, 17]                      # 34 tokens in 1 + 1 + 2 live blocks of 16
    kv_bytes = 34 * 8 * 64 * 2 * 2
    q_out_bytes = 2 * 3 * 32 * 64 * 2
    index_bytes = 4 * (4 + 3)
    assert pa.live_bytes(ctx, 16, 32, 8, 64, 2) == kv_bytes + q_out_bytes + index_bytes
    assert pa.bound_ms(ctx, 16, 32, 8, 64, 2) == pytest.approx(
        1e3 * pa.live_bytes(ctx, 16, 32, 8, 64, 2) / 3.35e12)


def _meta_args(name):
    """Arguments of a ported entry point, on a device that has no kernel."""
    t = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    if name == "flash_attention":
        return t(1, 2, 8, 32), t(1, 2, 8, 32), t(1, 2, 8, 32)
    return (t(1, 2, 32), t(1, 8, 2, 32), t(1, 8, 2, 32),
            torch.empty(8, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention", "moe_gating",
                                  "ssm_scan", "mlstm_scan", "topk_scores", "borda_count"])
def test_unported_kernels_raise_by_name(name):
    """An entry point that cannot run raises an error naming its kernel: the
    unported ones always, the ported ones (flash and decode attention, since
    the scheduler/core slice) on a device that has neither a kernel nor the
    plain version."""
    if name in ("flash_attention", "decode_attention"):
        with pytest.raises(RuntimeError, match=name):
            getattr(ops, name)(*_meta_args(name))
        return
    with pytest.raises(NotImplementedError, match=name):
        getattr(ops, name)()


# ----------------------------------------------------------- import hygiene
def _port_files():
    return sorted(SRC.rglob("*.py")) + [SRC.parents[1] / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference_package():
    assert len(_port_files()) > 15
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "repro"), (
                    f"{path} imports {name}")


def test_port_modules_name_their_counterpart():
    for path in sorted(SRC.rglob("*.py")):
        doc = ast.get_docstring(ast.parse(path.read_text())) or ""
        assert "src/repro/" in doc, f"{path} does not name its counterpart"
