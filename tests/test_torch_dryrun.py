"""The port's dry-run (``repro_torch.launch.dryrun``) on reduced configs at
small shapes, on abstract meshes of one process.

* Every kind of cell (train, prefill, decode) of every arch completes on
  ``meta``: 1x1 and 2x1 for every arch, 2x2 for the archs a model axis can
  cut, and 1x2 and 2x1x2 (``pod``) for llama3-8b and mixtral-8x7b; nothing is allocated off ``meta`` but the
  optimizer's host scalars.
* Argument bytes equal the sum of the ``local_shard`` slices: parameters,
  moments as ``zero1_specs`` cuts them, the step, the batch, the caches.
* 1x1 counts no collective; at 1x2 the model-axis bytes of a prefill equal a
  count worked out from the layers.
* Refused archs give ``error`` records and ``main()`` exits non-zero.
* Counted FLOPs of the unsharded prefill, decode and train step against the
  reference's XLA ``cost_analysis()`` of the same jit on one CPU device, fp32
  (bf16 would add XLA's per-element converts of the weights to its count),
  d_model 256: the port counts the matrix products (``flop_counter``'s
  registry), the same dots XLA counts; XLA also counts the elementwise work
  (norms, softmax, rotary, AdamW), which is 0.7-3% of its count here.  So
  0.95 <= port / XLA <= 1.
"""
from __future__ import annotations

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_reduced as jreduced
from repro.models.model import LM as JLM
from repro.training.optimizer import OptimConfig as JOptim
from repro.training.optimizer import apply_updates as japply
from repro.training.optimizer import init_opt_state as jinit_opt
from repro_torch.configs import get_reduced, list_archs
from repro_torch.distributed import ShardingPlan
from repro_torch.distributed.sharding import (batch_specs, local_shape,
                                              param_specs, zero1_specs)
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.specs import batch_specs_for, cache_specs_for
from repro_torch.models import LM
from repro_torch.models.config import InputShape
from repro_torch.launch.roofline import inner_scan_flop_correction
from repro_torch.training.tree import leaves

MESHES = {"1x1": AbstractMesh(("data", "model"), (1, 1)),
          "2x1": AbstractMesh(("data", "model"), (2, 1)),
          "1x2": AbstractMesh(("data", "model"), (1, 2)),
          "2x2": AbstractMesh(("data", "model"), (2, 2)),
          "2x1x2": AbstractMesh(("pod", "data", "model"), (2, 1, 2))}
KINDS = ("train", "prefill", "decode")
B, S = 4, 8


def shape_of(kind, b=B, s=S) -> InputShape:
    return InputShape(f"test_{kind}", s, b, kind)


CELLS = ([(a, m) for a in list_archs() for m in ("1x1", "2x1")]
         + [(a, m) for a in list_archs()
            for m in (("1x2", "2x2", "2x1x2") if a in ("llama3-8b", "mixtral-8x7b")
                      else ("2x2",))])


def cell(arch, kind, mesh, **kw):
    return D.dryrun_cell(arch, shape_of(kind).name, mesh=MESHES[mesh], shape=shape_of(kind),
                         reduced=True, verbose=False, **kw)


@pytest.mark.parametrize("arch,mesh", CELLS, ids=lambda x: x)
def test_every_kind_completes_on_meta(arch, mesh):
    for kind in KINDS:
        rec = cell(arch, kind, mesh)
        ma, ca = rec["memory_analysis"], rec["cost_analysis"]
        assert ma["argument_size_in_bytes"] > 0 and ma["temp_size_in_bytes"] > 0, rec
        assert ma["output_size_in_bytes"] > 0 and ca["flops"] > 0 and ca["bytes accessed"] > 0
        assert ma["off_meta_bytes"] <= (64 if kind == "train" else 0), ma
        r = rec["roofline"]
        assert r["step_time_bound_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"])
        # a recurrence on meta runs one trip; the reference's correction
        # adds the others' matmul FLOPs (0 for an arch without one)
        assert r["inner_scan_correction"] == pytest.approx(inner_scan_flop_correction(
            get_reduced(arch), shape_of(kind)), rel=1e-5)
        assert rec["chips"] == math.prod(MESHES[mesh].shape.values())
        if mesh == "1x1":
            assert rec["collectives"]["total_bytes"] == 0, rec["collectives"]
        if kind == "decode":      # the caches are updated in place
            assert ma["alias_size_in_bytes"] > 0


def nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def local_bytes(tree, specs, mesh) -> int:
    return sum(nbytes(local_shape(t.shape, s, mesh), t.dtype)
               for t, s in zip(leaves(tree), leaves(specs)))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b"])
def test_argument_bytes_are_the_local_slices(arch, fsdp):
    mesh, plan = MESHES["2x2"], ShardingPlan(fsdp=fsdp)
    cfg = get_reduced(arch)
    tree = LM(cfg, device="meta").param_tree()
    pspecs = param_specs(tree, mesh, plan)
    params = local_bytes(tree, pspecs, mesh)
    fp32_moments = 2 * sum(4 * math.prod(local_shape(t.shape, s, mesh)) for t, s in zip(
        leaves(tree), leaves(zero1_specs(tree, pspecs, mesh, plan))))
    batch = batch_specs_for(cfg, shape_of("prefill"))
    rows = local_bytes(batch, batch_specs(batch, mesh), mesh)
    rec = cell(arch, "train", "2x2", plan=plan)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        params + fp32_moments + 4 + nbytes((B, S), torch.int32)
    rec = cell(arch, "prefill", "2x2", plan=plan)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == params + rows
    caches = cache_specs_for(cfg, shape_of("decode"))
    cache = sum(nbytes(t.shape, t.dtype) // (1 if t.dim() < 5 else 4)
                for t in leaves(caches) if t.is_floating_point()) + \
        sum(nbytes(t.shape, t.dtype) for t in leaves(caches) if not t.is_floating_point())
    rec = cell(arch, "decode", "2x2", plan=plan)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        params + cache + nbytes((B // 2, 1), torch.int32)


def test_model_axis_bytes_of_a_prefill_are_the_layers_sums():
    """Reduced llama at 1x2: the vocab-parallel embedding and each layer's
    ``wo`` and ``w_down`` sum a (B, S, D) activation over ``model``, and the
    vocab-split logits of the last position are gathered."""
    cfg = get_reduced("llama3-8b")
    rec = cell("llama3-8b", "prefill", "1x2")
    item = 2                                      # bf16 activations
    c = rec["collectives"]
    assert c["bytes"]["all-reduce"] == (1 + 2 * cfg.n_layers) * B * S * cfg.d_model * item
    assert c["counts"]["all-reduce"] == 1 + 2 * cfg.n_layers
    assert c["bytes"]["all-gather"] == B * cfg.vocab_size * item
    assert c["bytes_by_axis"] == {"model": c["total_bytes"]}


def test_refused_archs_give_error_records_and_a_failed_exit(tmp_path, capsys):
    """Every arch lays out on the production mesh now; a cell that raises
    (here an arch the registry does not know) still gives its error record
    and a failed exit."""
    out = tmp_path / "d.jsonl"
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "no-such-arch", "--shape", "prefill_32k", "--out", str(out)])
    assert e.value.code not in (0, None)
    rec, = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["error"].startswith("KeyError") and "no-such-arch" in rec["error"]
    # an arch the port refused before the heads could be cut inside a head:
    # the full record, exit 0
    D.main(["--arch", "hymba-1.5b", "--shape", "decode_32k", "--out", str(out)])
    ok = json.loads(out.read_text().splitlines()[-1])
    assert ok["mesh"] == "32x8" and "error" not in ok
    assert {"memory_analysis", "cost_analysis", "collectives", "roofline"} <= set(ok)
    # a cell the production mesh cuts: a record with every entry, exit 0
    D.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--out", str(out)])
    ok = json.loads(out.read_text().splitlines()[-1])
    assert ok["chips"] == 256 and ok["mesh"] == "32x8"
    assert {"memory_analysis", "cost_analysis", "collectives", "roofline"} <= set(ok)
    skipped, _ = D.dryrun_records(["stablelm-1.6b"], ["long_500k"], [False], verbose=False)
    assert "skipped" in skipped[0] and "error" not in skipped[0]


def jcost(compiled) -> float:
    ca = compiled.cost_analysis()
    return float((ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"])


def test_counted_flops_against_xla_cost_analysis():
    over = {"d_model": 256, "dtype": "float32"}
    jlm = JLM(dataclasses.replace(jreduced("llama3-8b"), scan_unroll=True, **over))
    params = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0)))
    b, s = 4, 32
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    caches = jax.eval_shape(lambda: jlm.init_caches(b, s))

    def train_step(p, o, batch):
        (loss, _), g = jax.value_and_grad(jlm.loss, has_aux=True)(p, batch)
        return japply(p, g, o, JOptim())

    opt = jax.eval_shape(lambda: jinit_opt(params))
    xla = {"prefill": jax.jit(jlm.prefill).lower(params, {"tokens": tok}),
           "decode": jax.jit(jlm.decode_step).lower(
               params, caches, jax.ShapeDtypeStruct((b, 1), jnp.int32),
               jax.ShapeDtypeStruct((), jnp.int32)),
           "train": jax.jit(train_step).lower(params, opt, {"tokens": tok})}
    for kind, lowered in xla.items():
        rec = D.dryrun_cell("llama3-8b", kind, mesh=MESHES["1x1"],
                            shape=InputShape(kind, s, b, kind), reduced=True,
                            verbose=False, cfg_overrides=over)
        ratio = rec["cost_analysis"]["flops"] / jcost(lowered.compile())
        assert 0.95 <= ratio <= 1.0, (kind, ratio)
