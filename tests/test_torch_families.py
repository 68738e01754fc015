"""The MoE, Hymba and xLSTM families' blocks through the port against the
reference, fp32, with the reference's weights: block kinds ``swa``, ``moe``,
``moe_swa``, ``hymba_g``, ``hymba_l``, ``mlstm`` and ``slstm`` in modes
``train``, ``prefill`` and ``decode`` (caches leaf by leaf, the sliding
window wrapped); ``moe_ffn`` with tokens dropped over capacity; and the
reference's prefill-plus-decode versus full-forward contract inside the
port.  Whole models and model-backed queries: test_torch_family_models.py.

Tolerances: fp32 values at 1e-4 (summation order of the matrix products;
the SSM scan's chunk is composed in another order than the reference's
``associative_scan``); expert ids, ranks and kept slots exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.kernels import ref as jref
from repro.models import blocks as JB
from repro.models import moe as JMOE
from repro.models.layers import rope_angles as jrope
from repro_torch.configs import get_reduced
from repro_torch.convert import to_tensor
from repro_torch.models import LM
from repro_torch.models import blocks as TB
from repro_torch.models import moe as TMOE
from repro_torch.models.layers import KVCache, rope_angles as trope
from repro_torch.models.ssm import SSMState
from repro_torch.models.xlstm import MLSTMState, SLSTMState

FAMILIES = ("mixtral-8x7b", "hymba-1.5b", "xlstm-1.3b")
ARCH_OF = {"swa": "mixtral-8x7b", "moe": "mixtral-8x7b", "moe_swa": "mixtral-8x7b",
           "hymba_g": "hymba-1.5b", "hymba_l": "hymba-1.5b",
           "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}
TOL = dict(atol=1e-4, rtol=1e-4)
PORT_CACHES = {c.__name__: c for c in (KVCache, SSMState, MLSTMState, SLSTMState)}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def cfgs(arch):
    return (dataclasses.replace(jget(arch), dtype="float32"),
            dataclasses.replace(get_reduced(arch), dtype="float32"))


def leaves(cache) -> list:
    """A port cache's tensors in the order ``jax.tree.leaves`` gives the
    reference's."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    return [t for c in cache for t in leaves(c)]


def to_port(jtree):
    """A reference cache (nested tuples / NamedTuples of arrays) as the
    port's, leaf by leaf, in the port's classes of the same names."""
    if isinstance(jtree, tuple) and hasattr(jtree, "_fields"):
        return PORT_CACHES[type(jtree).__name__](*map(to_port, jtree))
    if isinstance(jtree, tuple):
        return tuple(map(to_port, jtree))
    return to_tensor(np.asarray(jtree))


def check_caches(tc, jc):
    jl = jax.tree.leaves(jc)
    tl = leaves(tc)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.int32:
            assert (a.numpy() == np.asarray(b)).all()
        else:
            np.testing.assert_allclose(f32(a), f32(b), **TOL)


# ------------------------------------------------------------------ blocks
@torch.inference_mode()
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("kind", list(ARCH_OF))
def test_apply_stack_new_kinds_against_reference(kind, mode):
    """Two stacked layers of ``kind``, 20 positions against a window of 16
    (the ring wraps); decode continues the reference's own prefill cache
    with one token at position 20."""
    jcfg, cfg = cfgs(ARCH_OF[kind])
    jstack = JB.init_stack(jax.random.PRNGKey(3), kind, 2, jcfg)
    tstack = jax.tree.map(lambda a: to_tensor(np.asarray(a)), jstack)
    rng = np.random.default_rng(8)
    b, s, d = 2, 20, cfg.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    x1 = rng.standard_normal((b, 1, d)).astype(np.float32)
    recurrent = kind in ("mlstm", "slstm")

    def ctx(jax_side, start, n):
        pos = np.broadcast_to(start + np.arange(n, dtype=np.int32), (b, n)).copy()
        if recurrent:
            angles = None
        elif jax_side:
            angles = jrope(jnp.asarray(pos), cfg.hd, cfg.rope_theta)
        else:
            angles = trope(torch.from_numpy(pos), cfg.hd, cfg.rope_theta)
        out = {"angles": angles, "reserve": 2}
        if mode == "decode":
            out["position"] = jnp.int32(start) if jax_side else start
        return out

    if mode == "decode":
        _, jc0 = JB.apply_stack(kind, jcfg, jstack, jnp.asarray(x), ctx(True, 0, s),
                                None, "prefill")
        jx, jc = JB.apply_stack(kind, jcfg, jstack, jnp.asarray(x1), ctx(True, s, 1),
                                jc0, "decode")
        tc0 = to_port(jc0)
        tx, tc = TB.apply_stack(kind, cfg, tstack, torch.from_numpy(x1), ctx(False, s, 1),
                                tc0, "decode")
        assert leaves(tc)[0] is leaves(tc0)[0]        # updated in place
    else:
        jx, jc = JB.apply_stack(kind, jcfg, jstack, jnp.asarray(x), ctx(True, 0, s),
                                None, mode)
        tx, tc = TB.apply_stack(kind, cfg, tstack, torch.from_numpy(x), ctx(False, 0, s),
                                None, mode)
    np.testing.assert_allclose(f32(tx), f32(jx), **TOL)
    if mode == "train":
        assert tc is None and jc is None
    else:
        check_caches(tc, jc)


def test_windowed_caches_wrap_and_full_ones_reserve():
    """The cache lengths of each kind, as ``init_block_cache`` and the
    reference give them: ``min(sliding_window, cache_len)`` for windowed
    attention, ``cache_len`` for full attention, fixed-size states else."""
    for kind, arch in ARCH_OF.items():
        jcfg, cfg = cfgs(arch)
        for cache_len in (8, 40):
            want = jax.tree.map(lambda a: a.shape,
                                JB.init_block_cache(kind, jcfg, 3, cache_len))
            got = TB.init_block_cache(kind, cfg, 3, cache_len, device="cpu")
            assert [tuple(t.shape) for t in leaves(got)] == jax.tree.leaves(
                want, is_leaf=lambda v: isinstance(v, tuple) and all(
                    isinstance(i, int) for i in v))


# --------------------------------------------------------------------- moe
def _moe_params(seed=4):
    jcfg, cfg = cfgs("mixtral-8x7b")
    jp = JMOE.init_moe_params(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.d_ff, jcfg.moe,
                              jnp.float32)
    return jcfg, cfg, jp, {k: to_tensor(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("capacity", [2, 3, None])
def test_moe_ffn_drops_over_capacity_like_the_reference(capacity):
    """A forced small capacity drops slots; the outputs, the routing, and
    which slots are kept equal the reference's."""
    jcfg, cfg, jp, tp = _moe_params()
    x = np.random.default_rng(9).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    want = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg.moe, capacity=capacity)
    got = TMOE.moe_ffn(tp, torch.from_numpy(x), cfg.moe, capacity=capacity)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)

    # routing on the same logits: ids, gates, ranks and the kept slots
    logits = np.asarray(jnp.asarray(x).reshape(-1, cfg.d_model) @ jp["router"], np.float32)
    cap = TMOE.capacity_of(cfg.moe, 24, capacity)
    idx, gates, pos = TMOE.route(torch.from_numpy(logits), cfg.moe.top_k)
    ri, rg, rp, rkeep = jref.moe_gating_ref(jnp.asarray(logits), cfg.moe.top_k, cap)
    assert (idx.numpy() == np.asarray(ri)).all() and (pos.numpy() == np.asarray(rp)).all()
    assert ((pos < cap).numpy() == np.asarray(rkeep)).all()
    np.testing.assert_allclose(gates.numpy(), np.asarray(rg), atol=1e-6, rtol=0)
    if capacity is not None:
        assert not (pos < cap).all()               # slots were dropped


def test_moe_route_breaks_ties_to_the_lower_expert():
    logits = np.random.default_rng(10).standard_normal((16, 4)).astype(np.float32)
    logits[0] = 1.0
    logits[1, [1, 3]] = 5.0
    idx, _, pos = TMOE.route(torch.from_numpy(logits), 2)
    ri, _, rp, _ = jref.moe_gating_ref(jnp.asarray(logits), 2, 1 << 30)
    assert idx[0].tolist() == [0, 1] and idx[1].tolist() == [1, 3]
    assert (idx.numpy() == np.asarray(ri)).all() and (pos.numpy() == np.asarray(rp)).all()


def test_unported_moe_paths_raise_by_name():
    # router_aux_loss came with the training slice (held against the
    # reference in test_torch_training.py) and the sharded FFN with the
    # distributed slice (tests/test_torch_distributed.py): on a 1x1 mesh it
    # is the global dispatch.  Tensor parallelism takes every kind.  What is
    # left raises by name, as in the reference: the paged and prefix-KV
    # modes of a MoE block, whose capacity is ranked across the batch
    from repro_torch.launch.mesh import make_local_mesh
    cfg = get_reduced("mixtral-8x7b")
    p = TB.init_block(torch.Generator().manual_seed(0), "moe", cfg, "cpu")["moe"]
    x = torch.ones((1, 4, cfg.d_model), dtype=p["router"].dtype)
    aux = TMOE.router_aux_loss(p, x, cfg.moe)
    assert aux.dim() == 0 and torch.isfinite(aux)
    mesh = make_local_mesh(1, 1, device="cpu")
    assert torch.equal(TMOE.moe_ffn_sharded(p, x, cfg.moe, mesh, ("data",), "model"),
                       TMOE.moe_ffn(p, x, cfg.moe))
    block = TB.init_block(torch.Generator().manual_seed(0), "moe", cfg, "cpu")
    for mode in ("prefill_cont", "decode_paged"):
        with pytest.raises(NotImplementedError, match=f"{mode}.*'moe'"):
            TB.apply_block("moe", cfg, block, x, {}, None, mode)


@torch.inference_mode()
@pytest.mark.parametrize("arch", FAMILIES + ("mixtral-8x22b",))
def test_prefill_decode_matches_full_forward(arch):
    """The reference's contract (tests/test_models_smoke.py), inside the
    port, in the config's own bf16: a 16-token prefill plus one decode step
    gives the full 17-token forward's last logits to 4% of their scale."""
    cfg = get_reduced(arch)
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    full = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (2, 17)).astype(np.int32))
    x, _ = lm.forward({"tokens": full}, mode="train")
    ref = lm._head(x)[:, -1].float()
    _, caches = lm.prefill({"tokens": full[:, :16]}, reserve=4)
    logits, _ = lm.decode_step(caches, full[:, 16:], 16)
    err = float((ref - logits.float()).abs().max())
    assert err / (float(ref.abs().max()) + 1e-6) < 0.04
