"""Serving launcher: hosts a model behind the ORDER BY ModelOracle and runs a
semantic ORDER BY query against it.

Counterpart of ``src/repro/launch/serve.py``.  Same flags, and one more:
``--device`` (default ``cuda``), because the port's entry points need the CPU
asked for explicitly.  The weights are random, drawn from ``--seed`` (the
repository holds no checkpoint)::

    python -m repro_torch.launch.serve --full --query "degree of positivity"
    python -m repro_torch.launch.serve --device cpu --reduced

Sharded serving: ``--mesh DxM`` serves on a ("data", "model") mesh of D*M
processes, one per device: probe rounds split into per-data-shard row
slices, decode runs tensor-parallel over the model axis, and ``--fsdp``
additionally shards the weights over the data axes.  ``--mesh 1x1`` runs in
one process; a larger mesh runs under ``torchrun``, and only rank 0
prints::

    python -m repro_torch.launch.serve --mesh 1x1 --full
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 2x1 --device cpu --reduced
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core import as_keys, llm_order_by
from repro_torch.core.oracles.model_oracle import ModelOracle
from repro_torch.distributed.sharding import ShardingPlan
from repro_torch.launch.mesh import local_device, parse_mesh
from repro_torch.models import LM
from repro_torch.serving import ServeEngine

ITEMS = [
    "absolutely loved it, best purchase ever",
    "terrible, broke after one day",
    "it is fine, nothing special",
    "pretty good overall, minor flaws",
    "worst experience of my life",
    "exceeded every expectation",
    "mediocre at best",
    "would recommend with reservations",
]


def make_lm(cfg, device, seed: int) -> LM:
    """The served model: random weights drawn on ``device`` from ``seed``."""
    return LM(cfg, device=device,
              generator=torch.Generator(device=device).manual_seed(seed))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--query", default="degree of positivity")
    ap.add_argument("--path", default="auto")
    ap.add_argument("--strategy", default="borda")
    ap.add_argument("--limit", type=int, default=5)
    ap.add_argument("--budget", type=float, default=None)
    ap.add_argument("--items", nargs="*", default=None)
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a data x model mesh (e.g. 2x1, 1x2), one "
                         "process per device")
    ap.add_argument("--fsdp", action="store_true",
                    help="also shard weights over the data axes")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on; the CPU only when asked for")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    device = local_device(args.device)
    owns_group = args.mesh is not None and not dist.is_initialized()
    mesh = parse_mesh(args.mesh, device=device) if args.mesh else None
    if args.fsdp and mesh is None:
        raise SystemExit("--fsdp requires --mesh")
    # every process draws the same weights from the seed, then keeps its
    # slice of them
    lm = make_lm(cfg, device, args.seed)
    engine = ServeEngine(lm, max_new_tokens=16, device=device, mesh=mesh,
                         plan=ShardingPlan(fsdp=args.fsdp) if mesh else None)
    oracle = ModelOracle(engine)
    say = print if mesh is None or dist.get_rank() == 0 else (lambda *a: None)

    keys = as_keys(args.items or ITEMS)
    t0 = time.perf_counter()
    result, report = llm_order_by(
        keys, args.query, oracle, path=args.path, descending=True,
        limit=args.limit, budget=args.budget, strategy=args.strategy,
        sample_size=min(8, len(keys)))
    say(f"arch={cfg.name} path={result.path} calls={result.n_calls} "
        f"cost=${result.cost:.5f}")
    if report is not None:
        say(f"optimizer: chose={report.chosen.label} reason={report.reason} "
            f"membership={report.membership_rate:.2f}")
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    for i, k in enumerate(result.order):
        say(f"  {i+1}. {k.text}")
    tps = engine.stats.decode_tokens / dt if dt > 0 else 0.0
    mesh_note = f" mesh={args.mesh}" if args.mesh else ""
    say(f"engine stats: {engine.stats}")
    say(f"throughput:{mesh_note} decode_tokens={engine.stats.decode_tokens} "
        f"wall={dt:.3f}s decode_tokens_per_s={tps:.1f}")
    if owns_group:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
