"""Multi-process cases of ``tests/test_torch_distributed.py``.

Each case is a function ``case(rank, world, *args) -> result`` run by every
rank of a ``gloo`` group on the CPU.  :func:`run_ranks` spawns the ranks (a
``FileStore`` under the test's ``tmp_path``, no port), joins them within a
time limit, kills them on expiry, and returns every rank's result.  This
module is imported by name in the spawned processes, so pytest does not
collect it (no ``test_`` prefix).
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

PROBES = [("Criteria: relevance\nItem:", f" candidate passage {i:03d}\nRating:")
          for i in range(16)]
GEN = [(f"Judge {i}: rationale " + "r" * (3 * i), 2 + 2 * i) for i in range(4)]
ALL_PATHS = ("pointwise", "ext_pointwise", "quick", "ext_bubble", "ext_merge")


# ------------------------------------------------------------------ runner
def _main(rank, world, store_path, out_dir, case, args):
    torch.set_num_threads(1)
    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        result = ("ok", globals()[case](rank, world, *args))
    except Exception:                  # reported to, and raised by, the parent
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def start_ranks(case: str, world: int, tmp_path, *args):
    """Spawn ``world`` ranks running ``case``; :func:`join_ranks` collects
    them.  Several jobs may run at once."""
    ctx = mp.get_context("spawn")
    out_dir = os.path.join(str(tmp_path), f"{case}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_main, args=(r, world, store, out_dir, case, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return case, out_dir, procs


def join_ranks(job, timeout: float = 120.0):
    """Every rank's result of a :func:`start_ranks` job, in rank order.
    Raises with the first rank's traceback if one failed, and kills every
    rank if they have not all ended within ``timeout`` seconds."""
    case, out_dir, procs = job
    world = len(procs)
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        raise TimeoutError(f"{case}: {len(hung)} of {world} ranks still running "
                           f"after {timeout} s; killed")
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"{case}: rank {r} exited with "
                               f"{procs[r].exitcode} and left no result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"{case}: rank {r} failed:\n{value}")
        results.append(value)
    return results


def run_ranks(case: str, world: int, tmp_path, *args, timeout: float = 120.0):
    """Run ``case`` on ``world`` spawned ranks; returns their results in rank
    order (see :func:`join_ranks`)."""
    return join_ranks(start_ranks(case, world, tmp_path, *args), timeout)


# ------------------------------------------------------------------ helpers
def keys(n=8, seed=0):
    from repro_torch.core import as_keys
    rng = np.random.default_rng(seed)
    return as_keys([f"doc {'q' * (i % 5)} {i:03d}" for i in range(n)],
                   list(rng.standard_normal(n)))


def ledger(o):
    return (o.ledger.n_calls, o.ledger.input_tokens, o.ledger.output_tokens,
            list(o.ledger.records))


def fp32_llama(weights_path):
    """The reduced llama3-8b in fp32 holding the reference's weights
    (a pickled numpy tree)."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import from_jax_params
    with open(weights_path, "rb") as f:
        params = pickle.load(f)
    cfg = dataclasses.replace(get_reduced("llama3-8b"), dtype="float32")
    return from_jax_params(params, cfg, device="cpu")


def seeded(arch, dtype=None, vocab=None, seed=0):
    from repro_torch.configs import get_reduced
    from repro_torch.models import LM
    cfg = get_reduced(arch)
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype,
                              vocab_size=vocab or cfg.vocab_size)
    return LM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def engine(lm, **kw):
    from repro_torch.serving import ServeEngine
    return ServeEngine(lm, device="cpu", max_new_tokens=8, **kw)


def paths_and_ledgers(eng):
    from repro_torch.core import llm_order_by
    from repro_torch.core.oracles.model_oracle import ModelOracle
    out = []
    for path in ALL_PATHS:
        o = ModelOracle(eng)
        r, _ = llm_order_by(keys(), "relevance", o, path=path)
        out.append((r.uids(), ledger(o), r.cost))
    return out


def deferred_batch(eng):
    """All five paths as ONE deferred co-scheduled batch plus the GEN
    generates: (generated texts, [(uids, ledger)] per path, blocks left)."""
    from repro_torch.core import OrderQuery, llm_order_by_many
    from repro_torch.core.oracles.model_oracle import ModelOracle
    from repro_torch.serving import BatchScheduler
    ks = keys(12, seed=3)
    sched = BatchScheduler(eng, max_batch=4)
    rids = [sched.submit(p, n) for p, n in GEN]
    oracles = [ModelOracle(eng) for _ in ALL_PATHS]
    results = llm_order_by_many(
        [OrderQuery(keys=ks, criteria="relevance", oracle=o, path=path)
         for path, o in zip(ALL_PATHS, oracles)], scheduler=sched)
    sched.run()
    gen = [sched.completed[r].output for r in rids]
    eng.clear_prefix_cache()
    return gen, [(res.uids(), ledger(o)) for res, o in zip(results, oracles)], \
        eng.pool.blocks_in_use


def solo_batch(eng):
    """The same work one query and one generate at a time (sync)."""
    from repro_torch.core import llm_order_by
    from repro_torch.core.oracles.model_oracle import ModelOracle
    ks = keys(12, seed=3)
    solo = []
    for path in ALL_PATHS:
        o = ModelOracle(eng)
        r, _ = llm_order_by(ks, "relevance", o, path=path)
        solo.append((r.uids(), ledger(o)))
    gen = [eng.generate_lockstep([p], max_new_per=[n])[0] for p, n in GEN]
    return gen, solo


# ------------------------------------------------------------------- cases
def dp_case(rank, world, weights_path, data, fsdp):
    """Data parallel (``data`` x 1): the sharded engine against the
    unsharded one on the same LM, in the same process."""
    from repro_torch.distributed import ShardingPlan
    from repro_torch.launch.mesh import make_local_mesh
    lm = fp32_llama(weights_path)
    mesh = make_local_mesh(data, 1, device="cpu")
    base = engine(lm)
    eng = engine(lm, mesh=mesh, plan=ShardingPlan(fsdp=fsdp))
    out = dict(data_shards=eng.data_shards)
    out["probes_base"] = base.submit_probes(PROBES)
    out["probes"] = eng.submit_probes(PROBES)
    prompts, limits = [p for p, _ in GEN], [n for _, n in GEN]
    out["lockstep_base"] = base.generate_lockstep(prompts, max_new_per=limits)
    out["lockstep"] = eng.generate_lockstep(prompts, max_new_per=limits)
    # a paged generate whose first row retires after two steps: the rows
    # behind it move up a slot, so rows change data slice mid-generation
    moving = [3, 8, 8, 8]
    out["moving_base"] = base.generate(prompts, max_new_per=moving)
    out["moving"] = eng.generate(prompts, max_new_per=moving)
    out["paths_base"] = paths_and_ledgers(base)
    out["paths"] = paths_and_ledgers(eng)
    out["solo"] = solo_batch(base)
    out["deferred"] = deferred_batch(eng)
    out["stats"] = dataclasses.asdict(eng.stats)
    repl = engine(lm, mesh=mesh, dp_probe_slices=False)
    out["probes_replicated"] = repl.submit_probes(PROBES)
    out["stats_replicated"] = dataclasses.asdict(repl.stats)
    if fsdp:
        w = eng.lm.stacks[0]["ffn_w_up"]
        out["fsdp_local_shape"] = tuple(w.shape)
    return out


# (arch, dtype, vocab or None): an odd vocab takes the d_model-split
# embedding (and head) of param_specs' fallback, tied (minicpm) or not
TP_CASES = (("llama3-8b", "bfloat16", None), ("llama3-8b", "float32", None),
            ("mixtral-8x7b", "float32", None), ("llama3-8b", "float32", 515),
            ("minicpm-2b", "float32", 515))


def tp_case(rank, world, data, model):
    """Tensor parallel (``data`` x ``model``): probe logits of the sharded
    engine and the unsharded one for each of ``TP_CASES``, and a paged
    generate on the sharded bf16 llama engine."""
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(data, model, device="cpu")
    out = {}
    for case in TP_CASES:
        lm = seeded(*case)
        base, eng = engine(lm), engine(lm, mesh=mesh)
        out[case] = (base.submit_probes(PROBES), eng.submit_probes(PROBES))
        if case == TP_CASES[0]:
            prompts, limits = [p for p, _ in GEN], [n for _, n in GEN]
            out["generate"] = (base.generate(prompts, max_new_per=limits),
                               eng.generate(prompts, max_new_per=limits))
            eng.clear_prefix_cache()
            out["blocks_in_use"] = eng.pool.blocks_in_use
            out["local_heads"] = (eng.lm.stacks[0]["wq"].shape[-1] // lm.cfg.hd,
                                  tuple(eng.pool.arenas[0].k.shape))
    return out


def moe_ef_case(rank, world, capacity_factor):
    """Two data shards: ``moe_ffn_sharded`` on each shard's rows, the global
    dispatch of a row-split batch, and ``ef_allreduce`` of per-rank int8
    leaves."""
    from repro_torch.configs import get_reduced
    from repro_torch.distributed.context import shard_context
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.blocks import _moe, init_block
    from repro_torch.models.moe import moe_ffn, moe_ffn_sharded
    from repro_torch.training.compression import compress_leaf, ef_allreduce
    mesh = make_local_mesh(world, 1, device="cpu")
    cfg = dataclasses.replace(get_reduced("mixtral-8x7b"), dtype="float32")
    spec = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    cfg = dataclasses.replace(cfg, moe=spec)
    p = init_block(torch.Generator().manual_seed(0), "moe", cfg, "cpu")["moe"]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2 * world, 8, cfg.d_model))
                         .astype(np.float32))
    rows = x.shape[0] // world
    mine = x[rank * rows:(rank + 1) * rows]
    with torch.inference_mode():
        sharded = moe_ffn_sharded(p, mine, spec, mesh, ("data",), "model")
        with shard_context(mesh, ("data",)):
            global_split = _moe(p, mine, cfg)
        whole = moe_ffn(p, x, spec)
    g = torch.from_numpy(np.random.default_rng(100 + rank)
                         .standard_normal(1 << 12).astype(np.float32))
    q, scale, _ = compress_leaf(g, torch.zeros_like(g))
    reduced = ef_allreduce(mesh, ("data",), q, scale)
    return dict(x=x.numpy(), p={k: v.numpy() for k, v in p.items()},
                sharded=sharded.numpy(), global_split=global_split.numpy(),
                whole=whole.numpy(), q=q.numpy(), scale=float(scale),
                reduced=reduced.numpy())


# ------------------------------------------------------ sharded training
TRAIN_OPTIM = dict(lr=1e-3, warmup_steps=1, schedule="const", eps=1e-4)


def train_cfg(steps, a, c, ckpt_dir=None):
    from repro_torch.training import OptimConfig, TrainConfig
    return TrainConfig(steps=steps, log_every=0, grad_accum=a, compression=c,
                       ckpt_dir=ckpt_dir, ckpt_async=False,
                       optim=OptimConfig(**TRAIN_OPTIM))


def wide(arch):
    """The reduced config in fp32 at d_model 1152: a dim above 1024, so that
    ``zero1_specs`` cuts moments over the data axes."""
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), dtype="float32", d_model=1152)


def train_case(rank, world, data, model, runs, weights, batches, ckpt_dir=None,
               resume_dir=None, grads=False):
    """Each run ``(arch, plan keywords, grad_accum, compression)`` of
    ``runs`` through ``Trainer(mesh=, plan=)`` on a ``data`` x ``model``
    mesh, from the reference's weights (``weights``: arch -> pickled numpy
    tree) over two of ``batches``: its history and its gathered parameters
    (rank 0).  The first run checkpoints into ``ckpt_dir``; with
    ``resume_dir``, a llama run resumes from that directory's step 2 and
    takes step 3 (``"resumed"``).  With ``grads``, the first llama stack's
    ``wo`` gradient as ``torch.autograd.grad`` gives it under the shard
    context and as the trainer reduces it, on every rank."""
    from repro_torch.convert import from_jax_params
    from repro_torch.distributed import ShardingPlan
    from repro_torch.distributed.context import gather_tree
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training import Trainer
    from repro_torch.training.tree import flatten_with_path, leaves, path_str
    mesh = make_local_mesh(data, model, device="cpu")

    def load(arch):
        with open(weights[arch], "rb") as f:
            return from_jax_params(pickle.load(f), wide(arch), device="cpu")

    def whole(tr, state):
        tree = gather_tree(state["params"], tr.state_specs(state)["params"], mesh)
        return {path_str(p): t.detach().numpy().copy() for p, t in flatten_with_path(tree)}

    tensors = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    out = {}
    for i, (arch, plan, a, c) in enumerate(runs):
        tr = Trainer(load(arch), train_cfg(2, a, c, ckpt_dir if i == 0 else None),
                     mesh=mesh, plan=ShardingPlan(**plan))
        state = tr.init_state()
        snaps = []
        hist = tr.run(state, iter(tensors[:2]), resume=False,
                      on_step=lambda step, rec: snaps.append(whole(tr, state)))["history"]
        out[(arch, tuple(plan.items()), a, c)] = (
            [(r["loss"], r["grad_norm"]) for r in hist], snaps)
    if resume_dir is not None:
        tr = Trainer(load("llama3-8b"), train_cfg(3, 1, False, resume_dir), mesh=mesh)
        state = tr.init_state()
        hist = tr.run(state, iter(tensors[:3]), resume=True)["history"]
        out["resumed"] = ([(r["step"], r["loss"], r["grad_norm"]) for r in hist],
                          whole(tr, state))
    if grads:
        tr = Trainer(load("llama3-8b"), train_cfg(1, 1, False), mesh=mesh)
        state = tr.init_state()
        loss, raw = tr._loss_and_grads(tensors[0], leaves(state["params"]))
        raw = [g.clone() for g in raw]
        _, reduced = tr._reduce(loss, list(raw))
        i = [path_str(p) for p, _ in flatten_with_path(state["params"])].index("stacks/0/wo")
        out["grads"] = (raw[i].numpy(), reduced[i].numpy(), tuple(tr.pspecs[i]))
    return out if rank == 0 else {k: v for k, v in out.items() if k == "grads"}


# ------------------------------------ tensor parallelism for every arch
# arch -> the config overrides of its fp32 case: a model axis of 2 cuts
# inside a q head and inside a kv head (3 heads of 16), for the xLSTM inside
# a recurrent head; seamless keeps its heads and takes an odd vocab (the
# d_model-split table its stub frontend reads)
TP_ARCHS = {
    "minicpm-2b": dict(n_heads=3, n_kv_heads=3, head_dim=16),
    "qwen2-vl-7b": dict(n_heads=3, n_kv_heads=1, head_dim=16),
    "hymba-1.5b": dict(n_heads=3, n_kv_heads=1, head_dim=16),
    "xlstm-1.3b": dict(n_heads=3, n_kv_heads=3, head_dim=16),
    "seamless-m4t-medium": dict(vocab_size=515),
}


def tp_arch_cfg(arch, dtype="float32"):
    """The fp32 case's config of ``arch`` (``TP_ARCHS``), or the stock
    reduced config in ``dtype``."""
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch)
    if dtype != "float32":
        return dataclasses.replace(cfg, dtype=dtype)
    return dataclasses.replace(cfg, dtype="float32", **TP_ARCHS[arch])


def tp_batch(cfg, seed=7):
    """One training batch (numpy) of the arch's input mode: tokens, plus
    embeddings or the encoder's input."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 256, (4, 16)).astype(np.int32)}
    if cfg.input_mode == "embeds":
        out["embeds"] = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    if cfg.input_mode == "encdec":
        out["enc_embeds"] = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    return out


def router_choices(lm, eng):
    """Probe logits of ``eng`` and, for every router call of the
    submission, (router logits, top-k experts)."""
    import repro_torch.models.moe as M
    calls, route = [], M.route

    def record(logits, k):
        out = route(logits, k)
        calls.append((logits.float().numpy().copy(), out[0].numpy().copy()))
        return out

    M.route = record
    try:
        logits = eng.submit_probes(PROBES)
    finally:
        M.route = route
    return np.asarray(logits), calls


def tp_arch_case(rank, world, data, model, weights, plan):
    """Every arch of ``TP_ARCHS`` on a ``data`` x ``model`` mesh: probe
    logits and a ``generate`` of the sharded engine and the unsharded one,
    both in fp32 from the reference's weights (``weights``: arch -> pickled
    numpy tree) and in the stock bf16 config from a seed; one
    ``Trainer(mesh=, plan=ShardingPlan(**plan))`` step from the reference's
    weights (rank 0 keeps the history and the gathered parameters).  Then
    bf16 Mixtral's router choices in the sharded and the unsharded
    engine."""
    from repro_torch.convert import from_jax_params
    from repro_torch.distributed import ShardingPlan
    from repro_torch.distributed.context import gather_tree
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import LM
    from repro_torch.training import Trainer
    from repro_torch.training.tree import flatten_with_path, path_str
    mesh = make_local_mesh(data, model, device="cpu")
    prompts, limits = [p for p, _ in GEN], [n for _, n in GEN]
    out = {}
    for arch, path in weights.items():
        cfg = tp_arch_cfg(arch)
        with open(path, "rb") as f:
            params = pickle.load(f)
        lm = from_jax_params(params, cfg, device="cpu")
        base, eng = engine(lm), engine(lm, mesh=mesh)
        out[arch, "fp32"] = (np.asarray(base.submit_probes(PROBES)),
                             np.asarray(eng.submit_probes(PROBES)))
        out[arch, "generate"] = (base.generate(prompts, max_new_per=limits),
                                 eng.generate(prompts, max_new_per=limits))
        out[arch, "shapes"] = {path_str(p): tuple(t.shape) for p, t in
                               flatten_with_path(eng.lm.param_tree())}
        lm16 = LM(tp_arch_cfg(arch, "bfloat16"), device="cpu",
                  generator=torch.Generator().manual_seed(0))
        out[arch, "bf16"] = (np.asarray(engine(lm16).submit_probes(PROBES)),
                             np.asarray(engine(lm16, mesh=mesh).submit_probes(PROBES)))
        tr = Trainer(from_jax_params(params, cfg, device="cpu"), train_cfg(1, 1, False),
                     mesh=mesh, plan=ShardingPlan(**plan))
        state = tr.init_state()
        batch = {k: torch.from_numpy(v) for k, v in tp_batch(cfg).items()}
        hist = tr.run(state, iter([batch]), resume=False)["history"]
        tree = gather_tree(state["params"], tr.state_specs(state)["params"], mesh)
        out[arch, "train"] = ([(r["loss"], r["grad_norm"]) for r in hist],
                              [{path_str(p): t.detach().numpy().copy()
                                for p, t in flatten_with_path(tree)}])
    lm = seeded("mixtral-8x7b", "bfloat16")
    out["mixtral-bf16"] = (router_choices(lm, engine(lm)),
                           router_choices(lm, engine(lm, mesh=mesh)))
    return out if rank == 0 else {k: v for k, v in out.items() if "train" not in k}


# ------------------------------------------- context-parallel decode caches
# arch -> the fp32 config overrides of its case: qwen2-vl's 3 heads over 1
# kv head put a span that is not whole groups on each model rank
CP_ARCHS = {"stablelm-1.6b": {}, "mixtral-8x7b": {}, "hymba-1.5b": {},
            "qwen2-vl-7b": dict(n_heads=3, n_kv_heads=1, head_dim=16),
            "seamless-m4t-medium": {}}
# a 20-token prompt with 28 reserved slots: 48 full-attention slots, so a
# process's half starts empty; the windowed rings (16 slots) wrap in the
# prefill, and the 12 decode steps cross their slices' boundary
CP_PROMPT, CP_RESERVE, CP_STEPS, CP_ENC = 20, 28, 12, 10


def cp_cfg(arch, dtype="float32"):
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), dtype=dtype, **(
        CP_ARCHS[arch] if dtype == "float32" else {}))


def cp_inputs(cfg, batch, seed=11):
    """The prefill batch and the decode steps' inputs (numpy) of a ``batch``
    row case: tokens, or embeddings, plus the encoder's input."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        pre = {"embeds": rng.standard_normal((batch, CP_PROMPT, cfg.d_model)).astype(np.float32)}
        steps = [rng.standard_normal((batch, 1, cfg.d_model)).astype(np.float32)
                 for _ in range(CP_STEPS)]
    else:
        pre = {"tokens": rng.integers(0, cfg.vocab_size, (batch, CP_PROMPT)).astype(np.int32)}
        steps = [rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
                 for _ in range(CP_STEPS)]
    if cfg.input_mode == "encdec":
        pre["enc_embeds"] = rng.standard_normal((batch, CP_ENC, cfg.d_model)).astype(np.float32)
    return pre, steps


def cp_layouts(data, model):
    """(layout, global batch) of each case on a ``data`` x ``model`` mesh:
    batch 1 in the feature layout, its sequence cut over the data axes; batch
    2 under ``seq``, rows over data and the sequence over ``model``."""
    return ([("feature", 1)] if data > 1 else []) + ([("seq", 2)] if model > 1 else [])


def _cp_run(lm, pre, steps, rows, **kw):
    """Prefill and decode ``rows`` of the inputs; logits of every call, the
    prefill's caches and the caches after the last step (numpy)."""
    from repro_torch.models.blocks import map_cache

    def t(a):
        return torch.from_numpy(a[rows])

    def host(caches):
        return [map_cache(lambda x: (x.float() if x.is_floating_point() else x).numpy().copy(), c)
                for c in caches]

    with torch.inference_mode():
        logits, caches = lm.prefill({k: t(v) for k, v in pre.items()},
                                    reserve=CP_RESERVE, **kw)
        out, first = [logits.float().numpy().copy()], host(caches)
        for i, step in enumerate(steps):
            logits, caches = lm.decode_step(caches, t(step), CP_PROMPT + i)
            out.append(logits.float().numpy().copy())
    return out, first, host(caches)


def cp_case(rank, world, data, model, weights):
    """Every arch of ``CP_ARCHS`` in fp32 from the reference's weights
    (``weights``: arch -> pickled numpy tree), and the stock bf16 stablelm
    from a seed, on a ``data`` x ``model`` mesh: in each layout of
    :func:`cp_layouts`, a prefill and ``CP_STEPS`` decode steps of
    ``LM.sharded(mesh, ShardingPlan(cache_layout=...))`` given the global
    batch, beside the unsharded LM's on the same inputs.  Returns the
    logits, the caches after the prefill and after the last step, this
    process's rows and the cut of each stack's caches."""
    from repro_torch.convert import from_jax_params
    from repro_torch.distributed import ShardingPlan
    from repro_torch.distributed.context import shard_context
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import LM
    mesh = make_local_mesh(data, model, device="cpu")
    d_rank = int(mesh.get_local_rank("data"))
    lms = {}
    for arch, path in weights.items():
        with open(path, "rb") as f:
            lms[arch] = from_jax_params(pickle.load(f), cp_cfg(arch), device="cpu")
    lms["stablelm-bf16"] = LM(cp_cfg("stablelm-1.6b", "bfloat16"), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    out = {}
    for name, lm in lms.items():
        for layout, batch in cp_layouts(data, model):
            pre, steps = cp_inputs(lm.cfg, batch)
            split = batch % data == 0 and data > 1
            rows = slice(d_rank, d_rank + 1) if split else slice(0, batch)
            base = _cp_run(lm, pre, steps, slice(0, batch))
            sharded = lm.sharded(mesh, ShardingPlan(cache_layout=layout))
            with shard_context(mesh, ("data",) if split else ()):
                got = _cp_run(sharded, pre, steps, rows, global_batch=batch)
            cuts = [[getattr(c, "cut", None) for c in (st if type(st) is tuple else (st,))]
                    for st in got[1]]
            out[name, layout] = dict(base=base, got=got, rows=(rows.start, rows.stop),
                                     cuts=cuts)
    return out
