"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``src/repro/launch/train.py``, single device, as the
reference's launcher has no mesh flag (``Trainer(mesh=, plan=)`` is the
library's, README.md shows it under ``torchrun``).  Same flags, and
one more: ``--device`` (default ``cuda``), because the port's entry points
need the CPU asked for explicitly.  The schedule defaults to ``wsd`` for
minicpm-2b and ``cosine`` otherwise, as in the reference::

    python -m repro_torch.launch.train --arch minicpm-2b --full --batch 4 --seq 512 \\
        --grad-accum 2 --compress-grads --steps 4
    python -m repro_torch.launch.train --device cpu --reduced --steps 3
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.models import LM
from repro_torch.training import OptimConfig, TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default=None,
                    help="cosine|wsd|const (default: wsd for minicpm)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device to train on; the CPU only when asked for")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = torch.device(args.device)
    lm = LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    schedule = args.schedule or ("wsd" if args.arch == "minicpm-2b" else "cosine")
    tc = TrainConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        grad_accum=args.grad_accum, compression=args.compress_grads,
        optim=OptimConfig(lr=args.lr, schedule=schedule,
                          warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps),
    )
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=args.seq,
                                   global_batch=args.batch,
                                   seed=args.seed))
    trainer = Trainer(lm, tc)
    state = trainer.init_state()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"arch={cfg.name} params={n_params:,} schedule={schedule} "
          f"steps={args.steps} device={lm.device}")
    out = trainer.run(state, iter(pipe), resume=args.ckpt_dir is not None)
    h = out["history"]
    if h:
        print(f"done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}; "
              f"median step {trainer.watchdog.median*1e3:.0f}ms; "
              f"stragglers flagged: {len(trainer.watchdog.flagged)}")
    else:
        print("already trained to the target step (resumed a finished run)")
    if lm.device.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(lm.device) / 1e9:.2f} GB")
    return out


if __name__ == "__main__":
    main()
