"""Context-parallel decode caches in one process: a KV cache's sequence cut
over the data axes or over ``model`` (``distributed.sharding.cache_seq_cut``),
attended as partial softmax statistics (``layers.gqa_attention_partial``)
combined over the cut's axes (``distributed.context.softmax_combine``).

* The partial attention and the combine over 2 / 3 / 4 slices, emulated in
  one process (the combine's collectives reduce over a leading slice dim),
  against ``gqa_attention`` at 1e-6 in fp32: GQA, a span that is not whole
  groups, an empty slice, every slice empty, a ring that wraps across a
  slice boundary.
* ``KVCacheSlice``: the owner of a slot writes it, the others do not; a
  prefill's slice of a ring and of the ``reserve`` tail.
* ``cache_seq_cut`` against the port's and the reference's ``cache_specs``
  for every KV leaf of every arch, both layouts, both ``seq_shard_cache``
  settings; ``softmax_combine`` counted on a ``CountingMesh``.
* Dry-run cells on ``meta`` on the production mesh: k / v bytes a card equal
  the reference's ``cache_specs`` layout of the same shapes;
  ``--cache-layout seq`` through ``main``.
* At 1x1 nothing is cut: ``LM.sharded`` under ``cache_layout="seq"`` is
  bitwise the unsharded LM.

The gloo ranks (2x1, 1x2, 2x2) are ``tests/test_torch_context_parallel_ranks.py``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import sharding as JS
from repro.launch import specs as JSPECS
from repro.models.config import SHAPES as JSHAPES
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.distributed import ShardingPlan
from repro_torch.distributed import context as C
from repro_torch.distributed import sharding as TS
from repro_torch.distributed.context import CountingMesh, shard_context
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.specs import cache_specs_for
from repro_torch.models import LM
from repro_torch.models.blocks import _attend
from repro_torch.models.config import SHAPES
from repro_torch.models.layers import (NEG_INF, HeadSpan, KVCache, KVCacheSlice,
                                       gqa_attention, gqa_attention_partial)
from repro_torch.training.tree import leaves

TOL = dict(rtol=1e-6, atol=1e-6)


# ------------------------------------------------- emulated slices, one process
@pytest.fixture
def slice_collectives(monkeypatch):
    """``max_over`` / ``sum_over`` over a leading dim that stacks the
    slices, each slice given the group's result: ``softmax_combine`` as
    every process of the group runs it."""
    monkeypatch.setattr(C, "max_over", lambda x, mesh, axes: x.amax(0, keepdim=True).expand_as(x))
    monkeypatch.setattr(C, "sum_over", lambda x, mesh, axes: x.sum(0, keepdim=True).expand_as(x))


def combined(q, k, v, mask, parts, attend=gqa_attention_partial):
    """Attention of q over k / v (B, S, KV, hd) and mask (..., S) cut into
    ``parts`` contiguous slot slices: each slice's partial statistics, then
    ``softmax_combine``; every slice's result (they must agree)."""
    n = k.shape[1] // parts
    stats = [attend(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                    mask[..., i * n:(i + 1) * n]) for i in range(parts)]
    o, m, l = (torch.stack(s) for s in zip(*stats))
    out = C.softmax_combine(o, m, l, None, ("data",))
    for i in range(1, parts):
        torch.testing.assert_close(out[i], out[0], rtol=0, atol=0)
    return out[0].to(v.dtype)


def qkv(seed, b=2, sq=1, h=8, kv=2, s=24, hd=16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, sq, h, hd), generator=g), torch.randn((b, s, kv, hd), generator=g),
            torch.randn((b, s, kv, hd), generator=g))


def valid(s, lo, hi):
    pos = torch.arange(s)
    return ((pos >= lo) & (pos < hi))[None, None, None, None, :]


@pytest.mark.parametrize("parts", [2, 3, 4])
@pytest.mark.parametrize("case", ["gqa", "mha", "prefix", "one_slot", "queries"])
def test_partial_combine_equals_gqa_attention(slice_collectives, case, parts):
    h, kv, sq, lo, hi = dict(gqa=(8, 2, 1, 0, 24), mha=(4, 4, 1, 0, 24),
                             prefix=(6, 3, 1, 0, 7), one_slot=(8, 2, 1, 13, 14),
                             queries=(6, 2, 3, 2, 19))[case]
    q, k, v = qkv(parts, h=h, kv=kv, sq=sq)
    mask = valid(24, lo, hi)
    torch.testing.assert_close(combined(q, k, v, mask, parts), gqa_attention(q, k, v, mask), **TOL)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_empty_slice_weighs_nothing(slice_collectives, parts):
    """A prefill shorter than one slice: every later slice is all masked,
    its ``m`` is ``NEG_INF`` and its weight underflows to 0."""
    q, k, v = qkv(7)
    mask = valid(24, 0, 3)
    o, m, l = gqa_attention_partial(q, k[:, 20:], v[:, 20:], mask[..., 20:])
    assert (m == NEG_INF).all() and (l == 4).all()
    torch.testing.assert_close(combined(q, k, v, mask, parts), gqa_attention(q, k, v, mask), **TOL)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_every_slice_empty_averages_v(slice_collectives, parts):
    """Every slot masked: every slice weighs 1 and the result is the mean of
    V over all slots, which is the unsharded masked softmax's."""
    q, k, v = qkv(8)
    mask = valid(24, 0, 0)
    out = combined(q, k, v, mask, parts)
    torch.testing.assert_close(out, gqa_attention(q, k, v, mask), **TOL)
    torch.testing.assert_close(out[:, 0, 0], v.mean(dim=1)[:, 0], **TOL)


@pytest.mark.parametrize("parts", [2, 3])
def test_span_not_whole_groups(slice_collectives, parts):
    """A model rank's span of q heads that is not whole kv groups (heads 1-3
    of 6 over 2 kv heads of 3): ``blocks._attend``'s per-kv-head calls join
    each of the partial statistics."""
    span = HeadSpan(h0=1, nq=3, kv0=0, nkv=2, col0=0, cols=48)
    assert not span.grouped(3)
    q, k, v = qkv(9, h=3, kv=2)
    mask = valid(24, 0, 17)
    whole = _attend(lambda q, k, v: gqa_attention(q, k, v, mask), q, k, v, span, 3)

    def attend(q, k, v, mask):
        return _attend(lambda q, k, v: gqa_attention_partial(q, k, v, mask), q, k, v, span, 3)

    torch.testing.assert_close(combined(q, k, v, mask, parts, attend), whole, **TOL)


@pytest.mark.parametrize("parts", [2, 4])
def test_ring_wrapping_across_slices(slice_collectives, parts):
    """A 16-slot ring filled by a 21-token prefill and 9 decode steps: the
    writes wrap the ring and cross every slice's boundary; each slice's
    owner writes its slots, and attention over the slices equals attention
    over the whole ring at every step."""
    g = torch.Generator().manual_seed(3)
    k, v = torch.randn((2, 21, 2, 8), generator=g), torch.randn((2, 21, 2, 8), generator=g)
    whole = KVCache.from_prefill(k, v, window=16)
    cuts = [TS.SeqCut(("data",), parts, i) for i in range(parts)]
    slices = [KVCache.from_prefill(k, v, window=16, cut=c) for c in cuts]
    for step in range(9):
        kn, vn = torch.randn((2, 1, 2, 8), generator=g), torch.randn((2, 1, 2, 8), generator=g)
        whole.update(kn, vn, 21 + step)
        for s in slices:
            s.update(kn, vn, 21 + step)
        for i, s in enumerate(slices):
            n = 16 // parts
            assert torch.equal(s.k, whole.k[:, i * n:(i + 1) * n])
            assert torch.equal(s.pos, whole.pos[i * n:(i + 1) * n])
        q = torch.randn((2, 1, 4, 8), generator=g)
        mask = whole.decode_mask()
        stats = [gqa_attention_partial(q, s.k, s.v, s.decode_mask()) for s in slices]
        o, m, l = (torch.stack(t) for t in zip(*stats))
        torch.testing.assert_close(C.softmax_combine(o, m, l, None, ("data",))[0],
                                   gqa_attention(q, whole.k, whole.v, mask), **TOL)


# ------------------------------------------------------------ slice ownership
def test_slice_update_only_on_owner():
    cut0, cut1 = TS.SeqCut(("model",), 2, 0), TS.SeqCut(("model",), 2, 1)
    a = KVCache.init(1, 8, 2, 4, torch.float32, "cpu", cut0)
    b = KVCache.init(1, 8, 2, 4, torch.float32, "cpu", cut1)
    assert isinstance(a, KVCacheSlice) and a.k.shape == (1, 4, 2, 4) and a.cut == cut0
    one = torch.ones((1, 1, 2, 4))
    for pos, owner in ((0, a), (3, a), (4, b), (7, b), (9, a), (13, b)):
        before = [t.clone() for t in (*a[:3], *b[:3])]
        owner.update(one * pos, one * pos, pos)
        other = b if owner is a else a
        other.update(one * pos, one * pos, pos)
        slot = pos % 8 - owner.cut.index * 4
        assert int(owner.pos[slot]) == pos and torch.equal(owner.k[0, slot], one[0, 0] * pos)
        changed = [not torch.equal(x, y) for x, y in zip(before, (*a[:3], *b[:3]))]
        assert changed[3:] == [False] * 3 if owner is a else changed[:3] == [False] * 3


def test_prefill_slice_of_reserve_tail():
    """A prefill of 5 tokens with 11 reserved slots over 4 parts: part 0
    holds positions 0-3, part 1 position 4 and three empty slots, parts 2
    and 3 are empty; every part's tensors are the whole cache's slots."""
    g = torch.Generator().manual_seed(4)
    k, v = torch.randn((2, 5, 3, 8), generator=g), torch.randn((2, 5, 3, 8), generator=g)
    whole = KVCache.from_prefill(k, v, reserve=11)
    for i in range(4):
        s = KVCache.from_prefill(k, v, reserve=11, cut=TS.SeqCut(("data",), 4, i))
        assert torch.equal(s.k, whole.k[:, 4 * i:4 * i + 4])
        assert torch.equal(s.v, whole.v[:, 4 * i:4 * i + 4])
        assert s.pos.tolist() == whole.pos[4 * i:4 * i + 4].tolist()
    assert whole.pos[4:8].tolist() == [4, -1, -1, -1]


# ----------------------------------------------------- the layout function
MESHES = {"32x8": (("data", "model"), (32, 8)), "2x32x8": (("pod", "data", "model"), (2, 32, 8)),
          "4x2": (("data", "model"), (4, 2)), "2x2x3": (("pod", "data", "model"), (2, 2, 3))}


class StubMesh(SimpleNamespace):
    """An abstract mesh seen from the process at ``coords``."""

    def get_local_rank(self, axis):
        return self.coords[axis]


def stub(name, coords=None):
    names, sizes = MESHES[name]
    coords = coords or {a: n - 1 for a, n in zip(names, sizes)}
    return StubMesh(axis_names=names, shape=dict(zip(names, sizes)), coords=coords)


def kv_leaves(tree):
    """Every k / v leaf of a cache tree (a KV cache's, or ``xdec``'s cross
    pair), with the slot count of its dim 2 after the layer dim."""
    out = []
    for c in tree:
        parts = c if type(c) is tuple else (c,)
        for p in parts:
            if hasattr(p, "_fields") and "k" in p._fields:
                out += [p.k, p.v]
            elif isinstance(p, torch.Tensor) and p.dim() == 5:
                out.append(p)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("layout", ["feature", "seq"])
@pytest.mark.parametrize("arch", list_archs())
def test_cache_seq_cut_decides_as_cache_specs(arch, layout, mesh):
    """For every KV leaf of the whole model's caches at a batch that divides
    the data axes and at batch 1, with ``seq_shard_cache`` on and off, the
    axes ``cache_seq_cut`` cuts dim 2 over are those of the port's and the
    reference's ``cache_specs``, and the slice index is ``axes_coord``."""
    cfg = get_config(arch)
    m = stub(mesh)
    lm = LM(cfg, device="meta")
    for batch in (1, 128):
        caches = lm.init_caches(batch, 4096, enc_len=512)
        for seq_shard in (True, False):
            plan = ShardingPlan(cache_layout=layout, seq_shard_cache=seq_shard)
            jplan = JS.ShardingPlan(cache_layout=layout, seq_shard_cache=seq_shard)
            for leaf in kv_leaves(caches):
                spec = TS.cache_specs(leaf, m, plan)
                jspec = JS.cache_specs(jax.ShapeDtypeStruct(tuple(leaf.shape), jax.numpy.bfloat16),
                                       m, jplan)
                assert TS.P(*spec) == TS.P(*tuple(jspec)), (leaf.shape, spec, jspec)
                want = spec[2] if len(spec) > 2 else None
                want = want if want is None or TS.axes_size(m, want) > 1 else None
                cut = TS.cache_seq_cut(plan, m, batch, leaf.shape[2])
                got = None if cut is None else TS.P(cut.axes)[0]
                assert got == want, (leaf.shape, batch, seq_shard, spec, cut)
                if cut is not None:
                    assert cut.parts == TS.axes_size(m, cut.axes)
                    assert cut.index == TS.axes_coord(m, cut.axes) == cut.parts - 1


def test_cache_seq_cut_none_at_one_part():
    one = SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": 1},
                          get_local_rank=lambda a: 0)
    for plan in (ShardingPlan(), ShardingPlan(cache_layout="seq")):
        assert TS.cache_seq_cut(plan, one, 1, 4096) is None


def test_softmax_combine_is_counted():
    cm = CountingMesh(make_production_mesh())
    o, m, l = torch.zeros((4, 1, 28, 128)), torch.zeros((4, 1, 28)), torch.ones((4, 1, 28))
    out = C.softmax_combine(o, m, l, cm, ("model",))
    assert out.shape == o.shape
    assert cm.records == [("all-reduce", "model", m.numel() * 4),
                          ("all-reduce", "model", (o.numel() + l.numel()) * 4)]


# ------------------------------------------------------------- dry-run cells
def jkv_bytes(arch, shape_name, plan, mesh):
    """The k / v bytes a card of the reference's decode caches of a cell
    under its ``cache_specs``."""
    caches = JSPECS.cache_specs_for(jget_config(arch), JSHAPES[shape_name])
    specs = JS.cache_specs(caches, mesh, plan)
    total = 0
    flat = jax.tree_util.tree_flatten_with_path(caches)[0]
    sflat = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(flat, sflat):
        if getattr(path[-1], "name", None) not in ("k", "v"):
            continue
        shape = list(leaf.shape)
        for i, e in enumerate(spec):
            if e is not None:
                shape[i] //= TS.axes_size(mesh, e)
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch,shape,layout", [("mixtral-8x7b", "long_500k", "feature"),
                                               ("qwen2-vl-7b", "decode_32k", "seq")])
def test_dryrun_cell_kv_bytes_equal_reference_layout(arch, shape, layout):
    prod = make_production_mesh()
    plan = ShardingPlan(cache_layout=layout)
    cm = CountingMesh(prod)
    local = LM(get_config(arch), device="meta").sharded(cm, plan)
    shp = SHAPES[shape]
    rows = shp.global_batch // 32 if shp.global_batch % 32 == 0 else shp.global_batch
    caches = cache_specs_for(get_config(arch), shp, local, rows)
    kv = kv_leaves(caches)
    assert all(isinstance(c, KVCacheSlice) for c in caches)
    got = sum(t.numel() * t.element_size() for t in kv)
    duck = SimpleNamespace(axis_names=prod.axis_names, shape=dict(prod.shape))
    assert got == jkv_bytes(arch, shape, JS.ShardingPlan(cache_layout=layout), duck)
    rec = dryrun.dryrun_cell(arch, shape, plan=plan, verbose=False)
    cache_bytes = rec["memory_analysis"]["cache_size_in_bytes"]
    assert got <= cache_bytes <= got + sum(t.numel() * 4 for c in caches for t in [c.pos])
    assert rec["plan"]["cache_layout"] == layout
    if shape == "long_500k":        # batch 1: every data rank held it whole
        whole = local.init_caches(rows, shp.seq_len)
        assert sum(t.numel() * t.element_size() for t in kv_leaves(whole)) == 32 * got


def test_dryrun_main_cache_layout_seq(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--cache-layout", "seq",
                 "--out", str(out)])
    capsys.readouterr()
    rec = json.loads(out.read_text().splitlines()[0])
    assert "error" not in rec and rec["plan"]["cache_layout"] == "seq"
    feature = dryrun.dryrun_cell("stablelm-1.6b", "decode_32k", verbose=False)
    # 32 kv heads over 8 model ranks, or all 32 over an eighth of the slots:
    # the same k / v bytes, pos cut 8 ways more; the combine's all-reduces
    seq_ma, feat_ma = rec["memory_analysis"], feature["memory_analysis"]
    assert seq_ma["cache_size_in_bytes"] <= feat_ma["cache_size_in_bytes"]
    assert rec["collectives"]["counts"]["all-reduce"] > feature["collectives"]["counts"]["all-reduce"]


# ------------------------------------------------------------ 1x1: nothing cut
def test_mesh_1x1_seq_layout_bitwise():
    cfg = dataclasses.replace(get_reduced("stablelm-1.6b"), dtype="float32")
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    mesh = make_local_mesh(1, 1, device="cpu")
    sharded = lm.sharded(mesh, ShardingPlan(cache_layout="seq"))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 9)).astype(np.int32))
    with torch.inference_mode():
        want, wc = lm.prefill({"tokens": toks}, reserve=6)
        with shard_context(mesh, ("data",)):
            got, gc = sharded.prefill({"tokens": toks}, reserve=6, global_batch=2)
        assert all(type(c) is KVCache for c in gc)
        assert torch.equal(got, want)
        for step in range(4):
            tok = toks[:, step:step + 1]
            want, wc = lm.decode_step(wc, tok, 9 + step)
            with shard_context(mesh, ("data",)):
                got, gc = sharded.decode_step(gc, tok, 9 + step)
            assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(leaves(gc), leaves(wc)))
