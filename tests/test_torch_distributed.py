"""The distributed slice: ``repro_torch.distributed``, ``launch.mesh``,
``ServeEngine(mesh=)``, ``KVBlockPool(mesh=)``, ``moe_ffn_sharded`` and
``ef_allreduce``, on the CPU over ``gloo``.

* Specs: every spec function of the port equals the reference's, entry for
  entry, on duck-typed 16x16 and 2x16x16 meshes, and re-asserts the
  reference's own properties.
* 1x1, in this process (a world-1 group): the sharded engine is bitwise the
  unsharded one (probe logits, lockstep and paged generates, a query's order
  and ledger), ``dp_probe_slices`` counts, the fuzz loop over a meshed
  pool, the sharded MoE and ``ef_allreduce`` against the reference, the loss
  on a mesh.
* 2x1, two spawned ranks: bitwise against the unsharded port engine, fp32
  logits within 1e-4 of the reference's engine, every path's order and
  ledger, one deferred co-scheduled batch, and a decode row that changes
  data slice mid-generation; with ``fsdp`` too.
* 1x2 and 2x2 tensor parallel (two and four ranks): probe logits within the
  reference's ``TP_PSUM_RTOL`` / ``TP_PSUM_ATOL``, greedy argmax agreement
  at least 0.9.
* Two data shards: ``moe_ffn_sharded`` at per-shard capacity and
  ``ef_allreduce`` against numpy models.
"""
import dataclasses
import math
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro.configs import get_config as jfull, get_reduced as jget, list_archs
from repro.distributed import sharding as JS
from repro.models import LM as JLM
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.distributed import ShardingPlan, activation_spec, sequence_parallel_spec
from repro_torch.distributed import sharding as TS
from repro_torch.distributed.context import shard_context
from repro_torch.launch.mesh import AbstractMesh, make_local_mesh, parse_mesh
from repro_torch.models import LM
from repro_torch.serving.engine import TP_PSUM_ATOL, TP_PSUM_RTOL
from repro_torch.serving.kv_pool import KVBlockPool

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def duck(name):
    names, sizes = MESHES[name]
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def norm(spec) -> tuple:
    """A spec as a tuple of entries, 1-tuples as their bare name."""
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


def jspecs_by_path(tree):
    from jax.sharding import PartitionSpec
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for path, spec in flat:
        key = tuple(getattr(e, "key", getattr(e, "idx", None)) for e in path)
        out[key] = norm(spec)
    return out


def tspecs_by_path(tree):
    out = {}
    TS.map_with_path(lambda path, spec: out.__setitem__(path, norm(spec)), tree)
    return out


_SHAPES: dict = {}


def shapes(arch):
    """(the reference's eval_shape'd params, the port's parameter tree on the
    meta device) of ``arch``'s full config."""
    if arch not in _SHAPES:
        jlm = JLM(jfull(arch))
        jshape = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0)))
        lm = LM(get_config(arch), device="meta", generator=torch.Generator())
        _SHAPES[arch] = (jshape, lm.param_tree())
    return _SHAPES[arch]


# -------------------------------------------------------------------- specs
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_reference(arch, fsdp, mesh):
    """Entry for entry, then the reference's own properties: every sharded
    dim divides its axis product, and more than half of the parameters
    are sharded."""
    jshape, ttree = shapes(arch)
    m = duck(mesh)
    want = jspecs_by_path(JS.param_specs(jshape, m, JS.ShardingPlan(fsdp=fsdp)))
    tspec = TS.param_specs(ttree, m, ShardingPlan(fsdp=fsdp))
    assert tspecs_by_path(tspec) == want
    total = sharded = 0

    def check(leaf, spec):
        nonlocal total, sharded
        for dim, e in zip(leaf.shape, spec):
            if e is not None:
                assert dim % TS.axes_size(m, e) == 0, (arch, leaf.shape, spec)
        total += leaf.numel()
        sharded += leaf.numel() if any(e is not None for e in spec) else 0

    TS.map_tree(check, ttree, tspec)
    assert sharded / total > 0.5, f"{arch}: only {sharded / total:.0%} sharded"


def test_zero1_specs_equal_reference():
    jshape, ttree = shapes("llama3-8b")
    m = duck("16x16")
    plan = ShardingPlan(zero1=True)
    jp = JS.param_specs(jshape, m, JS.ShardingPlan())
    tp = TS.param_specs(ttree, m, plan)
    want = jspecs_by_path(JS.zero1_specs(jshape, jp, m, JS.ShardingPlan(zero1=True)))
    got = tspecs_by_path(TS.zero1_specs(ttree, tp, m, plan))
    assert got == want
    assert sum(got[k] != v for k, v in tspecs_by_path(tp).items()) > 0


def meta(shape):
    return torch.empty(shape, device="meta")


BATCHES = [{"tokens": (256, 4096), "positions": (3, 256, 128)},
           {"tokens": (3, 17), "scalar": ()},
           {"tokens": (512, 8), "positions": (3, 512, 8)}]
CACHES = [(4, 1, 524288, 5, 64), (32, 128, 32768, 8, 128), (2, 6, 100, 3, 12), (7,),
          (24, 64, 1024)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", range(len(BATCHES)))
def test_batch_specs_equal_reference(batch, mesh):
    m = duck(mesh)
    shp = BATCHES[batch]
    want = JS.batch_specs({k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shp.items()}, m)
    got = TS.batch_specs({k: meta(s) for k, s in shp.items()}, m)
    assert {k: norm(v) for k, v in got.items()} == {k: norm(v) for k, v in want.items()}
    if batch == 0 and mesh == "16x16":      # tests/test_sharding.py's own check
        assert got["tokens"] == TS.P("data") == TS.P(("data",))
        assert tuple(got["positions"])[1] == "data"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("layout", ["feature", "seq"])
@pytest.mark.parametrize("cache", range(len(CACHES)))
def test_cache_specs_equal_reference(cache, layout, mesh):
    m = duck(mesh)
    shp = CACHES[cache]
    for seq_shard in (True, False):
        jplan = JS.ShardingPlan(cache_layout=layout, seq_shard_cache=seq_shard)
        tplan = ShardingPlan(cache_layout=layout, seq_shard_cache=seq_shard)
        want = JS.cache_specs(jax.ShapeDtypeStruct(shp, jnp.bfloat16), m, jplan)
        assert norm(TS.cache_specs(meta(shp), m, tplan)) == norm(want), seq_shard
    if cache == 0 and layout == "feature" and mesh == "16x16":
        got = TS.cache_specs(meta(shp), m)         # context-parallel fallback
        assert got[1] is None and got[2] == "data"
    if cache == 1 and layout == "seq" and mesh == "16x16":
        got = TS.cache_specs(meta(shp), m, ShardingPlan(cache_layout="seq"))
        assert got[1] == "data" and got[2] == "model"


ARENAS = [(24, 768, 16, 32, 64), (2, 33, 4, 1, 2), (3, 10, 8, 5, 48), (1, 9, 16, 8, 128)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_arena_and_rows_specs_equal_reference(mesh):
    from repro.models.layers import PagedKV as JPagedKV
    from repro_torch.models.layers import PagedKV
    m = duck(mesh)
    for shp in ARENAS:
        j = JS.arena_specs([JPagedKV(*(jax.ShapeDtypeStruct(shp, jnp.bfloat16),) * 2)], m)
        t = TS.arena_specs([PagedKV(meta(shp), meta(shp))], m)
        assert [norm(s) for s in t[0]] == [norm(s) for s in j[0]], shp
        assert t[0].k[1] is None and t[0].k[2] is None       # blocks replicated
    for n_rows, ndim, axis in [(8, 2, 0), (0, 2, 0), (32, 3, 1), (16, 3, 1), (48, 1, 0),
                               (64, 5, 1), (3, 2, 0)]:
        assert (norm(TS.rows_spec(n_rows, ndim, m, axis))
                == norm(JS.rows_spec(n_rows, ndim, m, axis))), (n_rows, ndim, axis)


def test_abstract_mesh_and_parse_mesh_messages():
    m = AbstractMesh(("data", "model"), (16, 16))
    assert TS.data_axes(m) == ("data",) and TS.axis_size(m, "model") == 16
    with pytest.raises(ValueError, match="expects DxM"):
        parse_mesh("8")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        parse_mesh("2x2", device="cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_local_mesh(2, 1, device="cpu")


# -------------------------------------------------------- 1x1, in process
PROBES, GEN = R.PROBES, R.GEN


@pytest.fixture(scope="module")
def mesh11():
    return make_local_mesh(1, 1, device="cpu")


@pytest.fixture(scope="module")
def llama():
    return LM(get_reduced("llama3-8b"), device="cpu",
              generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def base(llama):
    return R.engine(llama)


def test_mesh_1x1_bitwise_identity(base, llama, mesh11):
    """The 1x1 mesh runs the whole sharded path (local parameters, the
    meshed pool, the row split and its gathers) and is bitwise the
    unsharded engine."""
    eng = R.engine(llama, mesh=mesh11)
    assert np.array_equal(base.submit_probes(PROBES), eng.submit_probes(PROBES))
    prompts, limits = [p for p, _ in GEN], [n for _, n in GEN]
    assert (eng.generate_lockstep(prompts, max_new_per=limits)
            == base.generate_lockstep(prompts, max_new_per=limits))
    assert (eng.generate(prompts, max_new_per=limits)
            == base.generate(prompts, max_new_per=limits))
    eng.clear_prefix_cache()
    assert eng.pool.blocks_in_use == 0
    # a replicated leaf is the model's own tensor, not a copy
    assert eng.lm.embed.data_ptr() == llama.embed.data_ptr()


def test_mesh_1x1_query_and_ledger_identity(base, llama, mesh11):
    from repro_torch.core import llm_order_by
    from repro_torch.core.oracles.model_oracle import ModelOracle
    eng = R.engine(llama, mesh=mesh11)
    ob, os_ = ModelOracle(base), ModelOracle(eng)
    rb, _ = llm_order_by(R.keys(), "relevance", ob, path="quick")
    rs, _ = llm_order_by(R.keys(), "relevance", os_, path="quick")
    assert rs.uids() == rb.uids()
    assert R.ledger(os_) == R.ledger(ob)


def test_dp_ablation_counts_submissions(llama, mesh11):
    sliced = R.engine(llama, mesh=mesh11)
    sliced.submit_probes(PROBES)
    assert sliced.stats.dp_sharded_submissions > 0
    assert sliced.stats.dp_replicated_submissions == 0
    repl = R.engine(llama, mesh=mesh11, dp_probe_slices=False)
    repl.submit_probes(PROBES)
    assert repl.stats.dp_replicated_submissions > 0
    assert repl.stats.dp_sharded_submissions == 0
    assert np.array_equal(sliced.submit_probes(PROBES), repl.submit_probes(PROBES))


def test_fsdp_plan_1x1_bitwise(base, llama, mesh11):
    eng = R.engine(llama, mesh=mesh11, plan=ShardingPlan(fsdp=True))
    assert np.array_equal(base.submit_probes(PROBES), eng.submit_probes(PROBES))


def test_paged_kernel_refused_on_a_mesh(llama, mesh11):
    with pytest.raises(ValueError, match="sharded engine"):
        R.engine(llama, mesh=mesh11, paged_kernel=True)


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_sharded_pool_1x1(seed, monkeypatch, mesh11):
    """``tests/test_fuzz_loop.py``'s op script (as ``test_torch_scheduler``
    runs it against the reference) over the port's REAL pool on a 1x1 mesh:
    the step trace equals the reference's unsharded run and the loop's
    invariants hold."""
    import test_torch_scheduler as ts

    class Meshed(ts.PortFakePagedEngine):
        def __init__(self, num_blocks=33, block_size=4, **kw):
            super().__init__(num_blocks=num_blocks, block_size=block_size, **kw)
            self.pool = KVBlockPool(ts.tiny_pool_lm(), num_blocks, block_size,
                                    device="cpu", mesh=mesh11)
            self.data_shards = 1

    monkeypatch.setitem(ts.FAKES, "repro_torch", Meshed)
    monkeypatch.setattr(ts, "PortFakePagedEngine", Meshed)
    ts.fuzz_contracts(ts.identical(ts.fuzz, seed, 40), seed)


def test_sharded_moe_matches_reference_loss(mesh11):
    """``moe_impl="sharded"`` on the 1x1 mesh against ``"global"``, both
    against the reference's losses on the same weights, within the
    reference's 1e-3."""
    from repro.distributed.context import shard_context as jctx
    from repro.launch.mesh import make_local_mesh as jmesh
    cfg_g = dataclasses.replace(jget("mixtral-8x7b"), moe_impl="global")
    cfg_s = dataclasses.replace(jget("mixtral-8x7b"), moe_impl="sharded")
    params = JLM(cfg_g).init(jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(0), (2, 32), 0, cfg_g.vocab_size)
    jl_g = float(jax.jit(JLM(cfg_g).loss)(params, {"tokens": tokens})[0])
    jm = jmesh(1, 1)
    with jm, jctx(jm, ("data",), "model"):
        jl_s = float(jax.jit(JLM(cfg_s).loss)(params, {"tokens": tokens})[0])
    np_params = jax.tree.map(np.asarray, params)
    batch = {"tokens": torch.from_numpy(np.asarray(tokens))}
    t_g = from_jax_params(np_params, dataclasses.replace(get_reduced("mixtral-8x7b"),
                                                         moe_impl="global"), device="cpu")
    t_s = from_jax_params(np_params, dataclasses.replace(get_reduced("mixtral-8x7b"),
                                                         moe_impl="sharded"), device="cpu")
    with torch.no_grad():
        tl_g = float(t_g.loss(batch)[0])
        with shard_context(mesh11, ("data",)):
            tl_s = float(t_s.sharded(mesh11).loss(batch)[0])
    assert abs(tl_s - tl_g) < 1e-3 and tl_s == tl_g     # 1x1: the same dispatch
    assert abs(tl_g - jl_g) < 1e-3 and abs(tl_s - jl_s) < 1e-3


def test_ef_allreduce_matches_reference(mesh11):
    from repro.launch.mesh import make_local_mesh as jmesh
    from repro.training import compression as jcomp
    from repro_torch.training import compression as tcomp
    g = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    jq, jscale, jerr = jcomp.compress_leaf(jnp.asarray(g), jnp.zeros(64, jnp.float32))
    jm = jmesh(1, 1)
    with jm:
        want = np.asarray(jcomp.ef_allreduce(jm, ("data",), jq, jnp.full((64,), jscale)))
    q, scale, err = tcomp.compress_leaf(torch.from_numpy(g), torch.zeros(64))
    got = tcomp.ef_allreduce(mesh11, ("data",), q, scale.expand(64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), q.numpy().astype(np.float32) * float(scale),
                               rtol=1e-6)
    assert float(err.abs().max()) <= float(scale) * 1.01


def test_loss_on_mesh_equals_unsharded(mesh11):
    """``LM.loss`` of the 1x1-sharded phi4-mini equals the unsharded loss,
    and so does it under a sequence-parallel activation spec (a layout
    statement only)."""
    lm = LM(get_reduced("phi4-mini-3.8b"), device="cpu",
            generator=torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32))}
    with torch.no_grad():
        want = lm.loss(batch)[0]
        local = lm.sharded(mesh11)
        with shard_context(mesh11, ("data",)):
            got = local.loss(batch)[0]
            with activation_spec(sequence_parallel_spec(("data",))):
                got_sp = local.loss(batch)[0]
    assert torch.isfinite(want) and torch.equal(got, want) and torch.equal(got_sp, want)
    with pytest.raises(ValueError, match="names axis 'pod'"):
        with shard_context(mesh11, ("data",)), \
                activation_spec(sequence_parallel_spec(("pod",))), torch.no_grad():
            local.loss(batch)


def test_elastic_replan_builds_a_runnable_mesh():
    from repro_torch.training.fault_tolerance import elastic_plan
    plan = elastic_plan(n_alive=1, model_parallel=1)
    assert plan.n_devices == 1
    mesh = make_local_mesh(plan.data, plan.model, device="cpu")
    lm = LM(get_reduced("llama3-8b"), device="cpu", generator=torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32)}
    with torch.no_grad(), shard_context(mesh, TS.data_axes(mesh)):
        loss = lm.sharded(mesh).loss(batch)[0]
    assert torch.isfinite(loss)


def test_tensor_parallel_limits_raise_by_name():
    """Every config lays out on a model axis of any size, as the reference's
    spec rules lay out every config (a dim the axis does not divide stays
    whole): each process's parameters are ``param_specs``' cut, and its
    caches hold the kv heads its layers attend.  The limit left raises by
    name, as in the reference: the paged kernel on a sharded engine."""
    from repro_torch.distributed.context import CountingMesh
    from repro_torch.models.blocks import kv_heads_on
    from repro_torch.models.layers import KVCache
    from repro_torch.serving import ServeEngine
    from repro_torch.training.tree import leaves

    def kv_counts(caches):
        parts = [p for c in caches for p in (c if type(c) is tuple else (c,))]
        return [p.k.shape[-2] for p in parts if isinstance(p, KVCache)]

    for arch in list_archs():
        cfg = get_config(arch)
        tree = LM(cfg, device="meta").param_tree()
        for model in (2, 8, 16):
            mesh = CountingMesh(AbstractMesh(("data", "model"), (1, model)))
            specs = TS.param_specs(tree, mesh)
            local = LM(cfg, device="meta").sharded(mesh)
            got = [tuple(t.shape) for t in leaves(local.param_tree())]
            assert got == [TS.local_shape(t.shape, s, mesh)
                           for t, s in zip(leaves(tree), leaves(specs))], (arch, model)
            kv = kv_counts(local.init_caches(1, 8, enc_len=4))
            assert kv == [kv_heads_on(cfg, model, 0)] * len(kv), (arch, model, kv)
            assert 0 < kv_heads_on(cfg, model, model - 1) <= cfg.n_kv_heads
    lm = LM(get_reduced("llama3-8b"), device="cpu")
    with pytest.raises(ValueError, match="paged_kernel is not supported on a sharded"):
        ServeEngine(lm, device="cpu", mesh=make_local_mesh(1, 1, device="cpu"),
                    paged_kernel=True)


# ------------------------------------------------------- multi-rank cases
@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's fp32 reduced llama3-8b weights (pickled numpy, for
    the ranks) and its unsharded engine's probe logits."""
    jcfg = dataclasses.replace(jget("llama3-8b"), dtype="float32")
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("weights") / "llama_fp32.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    ref = np.asarray(JEngine(jlm, params, max_new_tokens=8).submit_probes(PROBES))
    return str(path), ref


@pytest.fixture(scope="module")
def dp2(weights, tmp_path_factory):
    return R.run_ranks("dp_case", 2, tmp_path_factory.mktemp("dp2"), weights[0], 2, False)


def test_dp_2x1_probe_logits_bitwise_and_near_reference(dp2, weights):
    for out in dp2:
        assert out["data_shards"] == 2
        assert np.array_equal(out["probes"], out["probes_base"])
        np.testing.assert_allclose(out["probes"], weights[1], atol=1e-4, rtol=1e-4)
        assert np.array_equal(out["probes_replicated"], out["probes_base"])
    assert np.array_equal(dp2[0]["probes"], dp2[1]["probes"])


def test_dp_2x1_generates_bitwise(dp2):
    for out in dp2:
        assert out["lockstep"] == out["lockstep_base"]
        assert out["moving"] == out["moving_base"]
        assert out["lockstep"] == dp2[0]["lockstep"]


@pytest.mark.parametrize("path", range(len(R.ALL_PATHS)))
def test_dp_2x1_paths_orders_and_ledgers(dp2, path):
    for out in dp2:
        assert out["paths"][path] == out["paths_base"][path], R.ALL_PATHS[path]


def test_dp_2x1_deferred_batch_and_no_leak(dp2):
    for out in dp2:
        gen, per_path, blocks_left = out["deferred"]
        solo_gen, solo = out["solo"]
        assert gen == solo_gen
        assert per_path == solo
        assert blocks_left == 0, "sharded engine leaked blocks"


def test_dp_2x1_counters(dp2):
    for out in dp2:
        st, rp = out["stats"], out["stats_replicated"]
        assert st["dp_sharded_submissions"] > 0
        assert rp["dp_sharded_submissions"] == 0 and rp["dp_replicated_submissions"] > 0


def test_dp_2x1_fsdp(weights, tmp_path):
    outs = R.run_ranks("dp_case", 2, tmp_path, weights[0], 2, True)
    for out in outs:
        assert out["fsdp_local_shape"][1] == 64 // 2        # D over data
        assert np.array_equal(out["probes"], out["probes_base"])
        assert out["moving"] == out["moving_base"]
        assert out["deferred"][2] == 0


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tensor_parallel_within_tolerance(shape, tmp_path):
    """The reference's 4x2 contract on the reduced bf16 llama (its config):
    probe logits within TP_PSUM_RTOL / TP_PSUM_ATOL, argmax agreement at
    least 0.9.  In fp32 (llama, Mixtral's F-split experts, and an odd
    vocabulary's d_model-split embedding and head, tied or not) the sums'
    order is all that differs: the port's fp32 1e-4."""
    outs = R.run_ranks("tp_case", math.prod(shape), tmp_path, *shape)
    worst = {}
    for out in outs:
        assert out["local_heads"][0] == 4 // shape[1]
        assert out["local_heads"][1][3] == 2 // shape[1]      # arena kv heads
        assert out["blocks_in_use"] == 0
        for case in R.TP_CASES:
            ref, got = out[case]
            tol = (dict(rtol=TP_PSUM_RTOL, atol=TP_PSUM_ATOL) if case[1] == "bfloat16"
                   else dict(rtol=1e-4, atol=1e-4))
            np.testing.assert_allclose(got, ref, **tol)
            agree = float((ref.argmax(-1) == got.argmax(-1)).mean())
            assert agree >= 0.9, (case, agree)
            key = " ".join(str(c) for c in case)
            worst[key] = max(worst.get(key, 0.0), float(np.abs(got - ref).max()))
        assert out["generate"][1] == outs[0]["generate"][1]   # every rank agrees
    print(f"tensor parallel {shape}: worst |logit error| {worst}")


def np_moe(p, x, spec):
    """numpy model of the top-k MoE FFN at the capacity of ``x``'s tokens."""
    t = x.shape[0] * x.shape[1]
    xt = x.reshape(t, -1).astype(np.float64)
    logits = xt @ p["router"].astype(np.float64)
    e, k = spec.n_experts, spec.top_k
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    top = np.take_along_axis(logits, idx, -1)
    gates = np.exp(top - top.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    cap = max(math.ceil(spec.capacity_factor * k * t / e), 1)
    seen = np.zeros(e, np.int64)
    out = np.zeros_like(xt)
    for i in range(t):
        acc, norm_ = np.zeros(xt.shape[1]), 0.0
        for c in range(k):
            ex = idx[i, c]
            pos, seen[ex] = seen[ex], seen[ex] + 1
            if pos >= cap:
                continue
            h = xt[i] @ p["w_gate"][ex]
            h = h / (1 + np.exp(-h)) * (xt[i] @ p["w_up"][ex])
            acc += gates[i, c] * (h @ p["w_down"][ex])
            norm_ += gates[i, c]
        out[i] = acc / max(norm_, 1e-9)
    return out.reshape(x.shape)


def test_sharded_moe_and_ef_allreduce_two_shards(tmp_path):
    """Each data shard routes its own tokens at per-shard capacity; the
    global dispatch of the same split batch ranks capacity over the whole
    batch; ef_allreduce is the int8 sum times the largest scale over n."""
    cf = 0.5                                 # drops slots: capacity matters
    outs = R.run_ranks("moe_ef_case", 2, tmp_path, cf)
    spec = dataclasses.replace(get_reduced("mixtral-8x7b").moe, capacity_factor=cf)
    x, p = outs[0]["x"], outs[0]["p"]
    rows = x.shape[0] // 2
    whole = np_moe(p, x, spec)
    np.testing.assert_allclose(outs[0]["whole"], whole, atol=1e-5, rtol=1e-5)
    for r, out in enumerate(outs):
        mine = x[r * rows:(r + 1) * rows]
        np.testing.assert_allclose(out["sharded"], np_moe(p, mine, spec),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(out["global_split"],
                                      out["whole"][r * rows:(r + 1) * rows])
    per_shard = np.concatenate([o["sharded"] for o in outs])
    assert not np.allclose(per_shard, whole, atol=1e-3), "per-shard capacity never bit"
    want = ((outs[0]["q"].astype(np.int64) + outs[1]["q"].astype(np.int64)).astype(np.float32)
            * np.float32(max(o["scale"] for o in outs)) / 2)
    for out in outs:
        np.testing.assert_allclose(out["reduced"], want, rtol=1e-6)
