"""Dry-run: count one rank's step of an (arch x shape x mesh) cell.

Counterpart of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's jitted step for 256 / 512 placeholder devices and reads
XLA's memory and cost analyses and the partitioned HLO.  The port is one
eager SPMD program a device, every rank running the same calls on a slice of
the same shapes, so the rank at coordinate 0 stands for all of them: its
step runs once, on ``meta`` tensors (shapes and dtypes, no storage, no
arithmetic), on a ``distributed.context.CountingMesh`` with the production
mesh's sizes (``launch.mesh.make_production_mesh``), under a dispatch mode
that counts every aten op.

* **The step** is the one a card runs: train, the sharded
  ``Trainer(mesh=, plan=)`` step (forward, backward, AdamW); prefill,
  ``LM.prefill``; decode, ``LM.decode_step``; the latter two on
  ``LM.sharded`` under ``shard_context`` and ``torch.no_grad()`` (under
  ``inference_mode`` composite ops such as ``matmul`` reach the counter
  undecomposed, and the registry knows ``mm``).  Parameters are built on
  ``meta`` (nothing drawn).  Decode caches are held as the sharded model computes
  them (``LM.init_caches`` of the sharded LM): rows over the data axes where
  the batch divides them; the kv heads, recurrent heads and SSM channels the
  rank's layers compute (kv heads over ``model`` where they divide, else the
  whole heads the rank's cut of the q heads reads; the reference's
  ``cache_specs`` may cut a cache's sequence or head_dim instead).
* **FLOPs**: ``torch.utils.flop_counter``'s registry over every op (matmuls,
  attention, convolutions; elementwise work counts 0, as in that counter).
* **Bytes**: each op's inputs and outputs (an eager program reads and writes
  HBM at every op), a strided input by the memory it spans; views move
  nothing; an index read moves the rows it gathers; an indexed write the
  rows it writes (read and written when it adds); ``copy_`` / ``fill_`` do
  not read their destination.
* **Collectives**: every ``all-reduce`` / ``all-gather`` of the counting
  mesh, forward and backward, by kind and by axis, result bytes.
* **Memory**: ``argument_size_in_bytes`` and ``output_size_in_bytes`` from
  the slices (``cache_size_in_bytes`` the decode caches among the
  arguments); ``alias_size_in_bytes`` the outputs that are arguments updated
  in place (state, caches); ``temp_size_in_bytes`` the high-water mark of
  the storages the step allocated and had not yet freed (outputs included).
* **Kernels**: no counted step reaches a hand-written kernel (the paged
  kernel is behind ``decode_step_paged``, whose block tables are data); a
  kernel wrapper given a ``meta`` tensor raises, so no kernel is ever counted
  by its plain version's ops.

A cell that raises (an unknown arch, say) gives a record with ``error`` and
a non-zero exit, as the reference's failures do; every arch of the
registry lays out on the production meshes.
``--save-hlo`` has no counterpart: an eager program has no HLO.  The
reference's ``--cache-layout seq`` has none either (see above)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape decode_32k --out dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.report dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
import weakref
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import get_config, get_reduced, list_archs
from ..distributed.context import (CountingMesh, activation_spec,
                                   sequence_parallel_spec, shard_context)
from ..distributed.sharding import (ShardingPlan, axes_size, batch_specs,
                                    data_axes, local_shard)
from ..models.config import SHAPES, InputShape
from ..models.model import LM
from ..training.train_loop import TrainConfig, Trainer
from ..training.tree import leaves
from .mesh import AbstractMesh, make_production_mesh, mesh_label
from .roofline import COLLECTIVE_OPS, roofline_terms
from .specs import (batch_specs_for, cache_specs_for, cell_applicable,
                    decode_token_spec)

aten = torch.ops.aten
# ops whose destination is written, not read
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
# indexed writes into their first argument: the rows of the values written
# (read and written where they add)
_INDEX_WRITE = {aten.index_put_: 1, aten.index_put: 1, aten.index_copy_: 1,
                aten.index_copy: 1, aten.scatter_: 1, aten.scatter: 1,
                aten.index_add_: 2, aten.index_add: 2, aten.scatter_add_: 2,
                aten.scatter_add: 2, aten.index_reduce_: 2}
# index reads: their source moves the rows they gather (the output's size)
_INDEX_READ = {aten.embedding, aten.index, aten.index_select, aten.gather}


def _tensors(tree) -> list:
    out: list = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            out.extend(_tensors(v))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out.extend(_tensors(v))
    return out


def _span_bytes(t: torch.Tensor) -> int:
    """The memory a (possibly strided or expanded) tensor covers."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    return min(span, t.numel()) * t.element_size()


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


class StepCounter(TorchDispatchMode):
    """Counts every aten op run under it: FLOPs (``flop_registry``), bytes
    moved and the live storages the ops allocate (see the module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.off_meta = 0           # bytes the ops allocated off meta
        self._alive: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def _track(self, inputs: list, outputs: list) -> None:
        mine = {id(t.untyped_storage()) for t in inputs}
        for t in outputs:
            st = t.untyped_storage()
            key = id(st)
            if key in mine or key in self._alive:
                continue
            self._alive[key] = st.nbytes()
            self.live += st.nbytes()
            if t.device.type != "meta":
                self.off_meta += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _traffic(self, func, args, inputs: list, outputs: list) -> int:
        packet = func._overloadpacket
        if func.is_view or all(any(o.untyped_storage() is i.untyped_storage()
                                   for i in inputs) for o in outputs) \
                and not func._schema.is_mutable:
            return 0                                  # aliases only
        out_bytes = sum(o.numel() * o.element_size() for o in outputs)
        if packet in _INDEX_READ:
            rest = [t for t in inputs if t is not args[0]]
            return 2 * out_bytes + sum(_span_bytes(t) for t in rest)
        if packet in _INDEX_WRITE:
            dst = args[0]
            rest = [t for t in inputs if t is not dst]
            vals = max((_span_bytes(t) for t in rest if t.dtype == dst.dtype),
                       default=0)
            touched = _INDEX_WRITE[packet] * vals
            return touched + sum(_span_bytes(t) for t in rest) + (
                0 if func._schema.is_mutable else out_bytes)
        if packet in _WRITE_ONLY:
            return sum(_span_bytes(t) for t in inputs[1:]) + _span_bytes(args[0])
        return sum(_span_bytes(t) for t in inputs) + out_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        inputs = _tensors(args) + _tensors(kwargs)
        outputs = _tensors(out)
        self.bytes += self._traffic(func, args, inputs, outputs)
        self._track(inputs, outputs)
        return out


# ---------------------------------------------------------------- the cells
def _rows(tree, mesh):
    """This rank's rows of a batch tree, and whether they are split."""
    specs = batch_specs(tree, mesh)
    split = any(e is not None and axes_size(mesh, e) > 1
                for s in leaves(specs) for e in s)
    return local_shard(tree, specs, mesh), split


def _collectives(records: list) -> dict:
    by_kind = {k: 0 for k in COLLECTIVE_OPS}
    counts = {k: 0 for k in COLLECTIVE_OPS}
    by_axis: dict[str, int] = {}
    for kind, axis, nbytes in records:
        by_kind[kind] += nbytes
        counts[kind] += 1
        by_axis[axis] = by_axis.get(axis, 0) + nbytes
    return {"bytes": by_kind, "counts": counts, "bytes_by_axis": by_axis,
            "total_bytes": sum(by_kind.values())}


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                plan: ShardingPlan = ShardingPlan(), verbose: bool = True,
                unroll: bool = True, seq_parallel: bool = False,
                cfg_overrides: Optional[dict] = None,
                mesh: Optional[AbstractMesh] = None,
                shape: Optional[InputShape] = None, reduced: bool = False) -> dict:
    """Count one (arch x shape x mesh) cell; returns the record.  ``mesh``
    and ``shape`` replace the production mesh and ``SHAPES[shape_name]``
    (smaller meshes and card-sized shapes); ``reduced`` takes the arch's
    reduced config.  ``unroll`` is recorded only: the port has no rolled
    scans."""
    t0 = time.time()
    cfg = dataclasses.replace((get_reduced if reduced else get_config)(arch),
                              scan_unroll=unroll,
                              **(cfg_overrides or {}))
    shape = shape or SHAPES[shape_name]
    amesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec: dict[str, Any] = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "chips": int(amesh.size), "mesh": mesh_label(amesh), "kind": shape.kind,
        "plan": {"fsdp": plan.fsdp, "zero1": plan.zero1,
                 "seq_parallel": seq_parallel, "unroll": unroll,
                 **(cfg_overrides or {})},
    }
    ok, why = cell_applicable(cfg, shape_name)
    if not ok:
        rec["skipped"] = why
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {why}")
        return rec

    cmesh = CountingMesh(amesh)
    daxes = data_axes(cmesh)
    lm = LM(cfg, device="meta")
    counter = StepCounter()
    act = (activation_spec(sequence_parallel_spec(daxes)) if seq_parallel
           else contextlib.nullcontext())
    if shape.kind == "train":
        trainer = Trainer(lm, TrainConfig(), mesh=cmesh, plan=plan)
        state = trainer.init_state()
        batch = batch_specs_for(cfg, shape)
        args = [state, batch]
        with act, counter:
            state, metrics = trainer.step(state, batch)
        outs = [state, metrics]
    else:
        local = lm.sharded(cmesh, plan)
        if shape.kind == "prefill":
            batch, split = _rows(batch_specs_for(cfg, shape), cmesh)
            args = [local.param_tree(), batch]
            with shard_context(cmesh, daxes if split else ()), act, \
                    torch.no_grad(), counter:
                outs = list(local.prefill(batch))
        else:
            token, split = _rows(decode_token_spec(cfg, shape), cmesh)
            caches = cache_specs_for(cfg, shape, local, token.shape[0])
            # the cache's last position (a ring's wraps past its window)
            position = (shape.seq_len // 2 if cfg.input_mode == "encdec"
                        else shape.seq_len) - 1
            args = [local.param_tree(), caches, token]
            with shard_context(cmesh, daxes if split else ()), act, \
                    torch.no_grad(), counter:
                outs = list(local.decode_step(caches, token, position))
    rec["count_s"] = round(time.time() - t0, 2)
    arg_t, out_t = _tensors(args), _tensors(outs)
    cache_t = _tensors(args[1]) if shape.kind == "decode" else []
    arg_ids = {id(t.untyped_storage()) for t in arg_t}
    rec["memory_analysis"] = {
        "argument_size_in_bytes": storage_bytes(arg_t),
        "cache_size_in_bytes": storage_bytes(cache_t),
        "output_size_in_bytes": storage_bytes(out_t),
        "alias_size_in_bytes": storage_bytes(
            [t for t in out_t if id(t.untyped_storage()) in arg_ids]),
        "temp_size_in_bytes": counter.peak,
        # the optimizer's step count and schedule scalars are host tensors
        "off_meta_bytes": counter.off_meta,
    }
    rec["cost_analysis"] = {"flops": float(counter.flops),
                            "bytes accessed": float(counter.bytes),
                            "ops": counter.ops}
    rec["collectives"] = _collectives(cmesh.records)
    rec["roofline"] = roofline_terms(rec, cfg, shape)
    if verbose:
        ca = rec["cost_analysis"]
        print(f"[ok] {arch} x {shape_name} ({rec['mesh']}, {rec['chips']} cards) "
              f"counted in {rec['count_s']}s")
        print(f"     memory_analysis: {rec['memory_analysis']}")
        print(f"     cost_analysis: flops/device={ca['flops']:.3e} "
              f"bytes/device={ca['bytes accessed']:.3e} ops={ca['ops']}")
        print(f"     collectives (per-device bytes): {rec['collectives']}")
        print(f"     roofline: {rec['roofline']}")
    return rec


def dryrun_records(archs, shapes, meshes, *, out: Optional[str] = None,
                   **kw) -> tuple[list, int]:
    """:func:`dryrun_cell` over ``archs`` x ``shapes`` x ``meshes`` (each a
    ``multi_pod`` flag); a cell that raises gives a record with ``error``.
    Returns the records and the number of failed cells; with ``out``, each
    record is appended to that JSONL file."""
    recs, n_fail = [], 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = dryrun_cell(arch, shape, multi_pod=mp, **kw)
                except Exception as e:   # one cell's failure is its record
                    n_fail += 1
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "error": f"{type(e).__name__}: {e}"}
                    if kw.get("verbose", True):
                        print(f"[FAIL] {arch} x {shape}: {e}")
                        traceback.print_exc()
                recs.append(rec)
                if out:
                    with open(out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    return recs, n_fail


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="production-mesh dry-run on meta")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="train_4k|prefill_32k|decode_32k|long_500k|all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--no-unroll", action="store_true",
                    help="recorded only: the port has no rolled scans")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="sequence-shard the residual stream over 'model'")
    ap.add_argument("--attn-impl", default=None,
                    choices=["einsum", "bf16", "qchunk"],
                    help="attention implementation override")
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=["none", "dots", "full"])
    ap.add_argument("--moe-impl", default=None, choices=["global", "sharded"])
    ap.add_argument("--scan-chunk", type=int, default=None,
                    help="SSM/mLSTM chunkwise length override")
    ap.add_argument("--cache-layout", default="feature", choices=["feature"],
                    help="the port's one decode cache layout")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    plan = ShardingPlan(fsdp=args.fsdp, zero1=not args.no_zero1,
                        cache_layout=args.cache_layout)
    overrides = {k: v for k, v in (("attn_impl", args.attn_impl),
                                   ("attn_chunk", args.attn_chunk),
                                   ("remat", args.remat),
                                   ("moe_impl", args.moe_impl),
                                   ("scan_chunk", args.scan_chunk)) if v}
    _, n_fail = dryrun_records(archs, shapes, meshes, out=args.out, plan=plan,
                               unroll=not args.no_unroll,
                               seq_parallel=args.seq_parallel,
                               cfg_overrides=overrides or None)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
