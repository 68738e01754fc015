"""Serving launcher: hosts a model behind the ORDER BY ModelOracle and runs a
semantic ORDER BY query against it.

Counterpart of ``src/repro/launch/serve.py``, single device.  Same flags, and
one more: ``--device`` (default ``cuda``), because the port's entry points
need the CPU asked for explicitly.  ``--mesh`` and ``--fsdp`` raise
``NotImplementedError``: sharded serving comes with the distributed slice.
The weights are random, drawn from ``--seed`` (the repository holds no
checkpoint)::

    python -m repro_torch.launch.serve --full --query "degree of positivity"
    python -m repro_torch.launch.serve --device cpu --reduced
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.core import as_keys, llm_order_by
from repro_torch.core.oracles.model_oracle import ModelOracle
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
                    help="not ported yet (the distributed slice)")
    ap.add_argument("--fsdp", action="store_true",
                    help="not ported yet (the distributed slice)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on; the CPU only when asked for")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh or args.fsdp:
        raise NotImplementedError(
            "--mesh/--fsdp (sharded serving) are not ported yet: they come "
            "with the distributed slice")

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    lm = make_lm(cfg, torch.device(args.device), args.seed)
    engine = ServeEngine(lm, max_new_tokens=16, device=args.device)
    oracle = ModelOracle(engine)

    keys = as_keys(args.items or ITEMS)
    t0 = time.perf_counter()
    result, report = llm_order_by(
        keys, args.query, oracle, path=args.path, descending=True,
        limit=args.limit, budget=args.budget, strategy=args.strategy,
        sample_size=min(8, len(keys)))
    print(f"arch={cfg.name} path={result.path} calls={result.n_calls} "
          f"cost=${result.cost:.5f}")
    if report is not None:
        print(f"optimizer: chose={report.chosen.label} reason={report.reason} "
              f"membership={report.membership_rate:.2f}")
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    for i, k in enumerate(result.order):
        print(f"  {i+1}. {k.text}")
    tps = engine.stats.decode_tokens / dt if dt > 0 else 0.0
    print(f"engine stats: {engine.stats}")
    print(f"throughput: decode_tokens={engine.stats.decode_tokens} "
          f"wall={dt:.3f}s decode_tokens_per_s={tps:.1f}")


if __name__ == "__main__":
    main()
