"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                           # everything; what a checkout must pass
    python3 chip_smoke.py --phases order_by,kernels # the ORDER BY path and the kernels
    python3 chip_smoke.py --phases families,kernels # the MoE / Hymba / xLSTM families
    python3 chip_smoke.py --phases archs            # phi4-mini, qwen2-vl, seamless-m4t
    python3 chip_smoke.py --phases train,kernels    # train minicpm-2b, resume, serve it
    python3 chip_smoke.py --phases kernels          # build and check the kernels only
    python3 chip_smoke.py --phases mesh             # the 1x1 mesh: sharded == unsharded
    python3 chip_smoke.py --phases launch           # dry-run grid, roofline vs card, pricing
    python3 chip_smoke.py --phases analysis         # the port's linter, on a machine without JAX

Builds every CUDA kernel of ``repro_torch`` from the sources in this checkout
(one ``nvcc`` per source, all started together), then:

- ``analysis``: the port's invariant linter (``repro_torch.analysis``) over
  ``src/repro_torch``, ``tests`` and this script: no finding, no JAX module
  loaded;
- ``order_by`` (the main path): LLM ORDER BY queries through
  ``llm_order_by_many`` and ``llm_order_by`` -> access paths -> ``ModelOracle``
  -> ``BatchScheduler`` -> ``ServeEngine(paged_kernel=True)`` at the full width
  of ``stablelm-1.6b`` with seeded random weights; judge rationales decode
  through the paged attention kernel;
- ``families``: ``hymba-1.5b`` and ``xlstm-1.3b`` at full size and
  ``mixtral-8x7b`` at full width with its depth cut to 4 of 32 layers, each
  served by ``ServeEngine`` (an ORDER BY query and a ``generate``; Hymba's
  longest prompt wraps its 1024-token window), then the tensors layer 0
  produces on a probe batch through ``ops.moe_gating``, ``ops.ssm_scan`` and
  ``ops.mlstm_scan``, held against the plain versions and the model path's
  own results;
- ``archs``: ``phi4-mini-3.8b``, ``qwen2-vl-7b`` (M-RoPE, embeddings as
  input) and ``seamless-m4t-medium`` (encoder-decoder) at full width and
  full depth, one after another, each serving a judged ORDER BY query and a
  ``generate``: phi4-mini through the paged attention kernel at its group of
  3 (a ``"check"`` engine first), then the same weights as
  ``attn_impl="qchunk"`` against the einsum engine's logits; the other two
  through monolithic prefill and the lockstep loop; each with the
  reference's prefill-plus-decode against forward contract;
- ``train``: ``minicpm-2b`` at full size (40 layers, 2.7 B parameters, bf16)
  trained a few steps through ``Trainer`` with the training example's
  settings (two microbatches, int8 error-feedback gradients, the WSD
  schedule); a crash-and-resume drill at full width with the depth cut to
  2 layers, whose resumed parameters must equal an uninterrupted run's bit
  for bit; then the trained 40-layer weights served through
  ``ServeEngine(paged_kernel=True)`` -> ``ModelOracle`` -> ``llm_order_by``
  (the example's ``ext_pointwise ... LIMIT 5`` query and the budget-aware
  optimizer with Borda selection), and ``ops.topk_scores`` and
  ``ops.borda_count`` on the scores and ballots those queries produced, held
  against their plain versions and against the path's own top 5 and Borda
  points;
- ``kernels``: each kernel against its plain PyTorch version over the CPU
  tests' sweeps, edge cases and at full width, timed beside its bound, its plain version
  and, where one exists, the PyTorch call that computes the same function;
- ``ops``: ``flash_attention`` and ``decode_attention`` through
  ``repro_torch.kernels.ops``, the entry points the reference reaches them by;
- ``mesh``: the distributed slice on one card, through NCCL at world size 1:
  ``ServeEngine(mesh=)`` on a 1x1 mesh at ``stablelm-1.6b``'s full size with
  phase ``order_by``'s weights, bitwise against the unsharded engine (probe
  logits, ``quick`` and ``pointwise`` orders and ledgers, a paged
  ``generate``), the ``dp_probe_slices`` counters, no leaked block, an
  ``fsdp`` plan; ``moe_impl="sharded"`` against ``"global"`` on
  ``mixtral-8x7b`` at full width with 4 of 32 layers; ``ef_allreduce``
  of a 2^20-element leaf; and ``minicpm-2b``, ``qwen2-vl-7b``,
  ``hymba-1.5b``, ``xlstm-1.3b`` and ``seamless-m4t-medium`` at full width
  and depth in bf16, seeded, each a 1x1 sharded engine bitwise the
  unsharded one (probe logits, a ``quick`` order and ledger, a
  ``generate``); ``stablelm-1.6b``'s ``LM.sharded`` under
  ``cache_layout="seq"`` given the global batch, a prefill and 16 decode
  steps bitwise the unsharded LM's (at one part nothing is cut).  The
  sharded engine decodes through the dense
  paged path (the reference refuses the paged kernel on a mesh), so this
  path launches no kernel;
- ``launch``: the launch-tooling slice.  ``launch.dryrun`` over every arch x
  shape on the production mesh (32x8) and llama3-8b's shapes on the
  multi-pod one (2x32x8), on ``meta``: no error record, each of the 37
  applicable cells fully counted (each cell of the archs a cut inside a
  head, Hymba's SSM, the xLSTM, the encoder-decoder or the VLM's embeddings
  brought to tensor parallelism last prints its per-card bytes and bound);
  every ``decode_32k`` cell again under ``cache_layout="seq"`` (32x8, and
  llama3-8b's on 2x32x8), and for those and the ``long_500k`` cells (batch
  1: the sequence cut over ``data``) a ``launch.cache_layout`` line, the
  K / V bytes a card held equal to the reference's ``cache_specs`` layout's
  where it keeps whole kv heads; the report's tables.  Then ``stablelm-1.6b`` at full
  size with phase ``order_by``'s weights on a 1x1 NCCL mesh: a price sheet
  from the grid's records (an assumed $/card-hour) drives a judged ``auto``
  query through ``ServeEngine(paged_kernel=True)``, whose cost must be its
  oracle's spend; three card-sized cells (decode, prefill, train) counted at
  1x1 and timed on the card, none faster than its bound, argument bytes
  equal; and ``Trainer(mesh=, plan=)`` on minicpm-2b at full width (2 of 40
  layers), zero1, fsdp and two microbatches with int8 error feedback,
  bitwise the unsharded trainer's, checkpoint files byte-equal;
- ``main``, ``llama`` (the serving path of the first slice), and ``profile``
  (not in the default run).

Fails (non-zero exit, no result line) when there is no CUDA device, when a
kernel does not build, launch or agree, when a path did not go through its
kernels, or when an ORDER BY or training contract breaks.  The last line of the output is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config, get_reduced, list_archs  # noqa: E402
from repro_torch.core import OrderQuery, as_keys, llm_order_by, llm_order_by_many  # noqa: E402
from repro_torch.core.access_paths import pointwise as pointwise_mod  # noqa: E402
from repro_torch.core.optimizer import optimizer as optimizer_mod  # noqa: E402
from repro_torch.core.optimizer.borda import borda_matrix  # noqa: E402
from repro_torch.core.oracles.model_oracle import ModelOracle  # noqa: E402
from repro_torch.data import DataConfig, DataPipeline  # noqa: E402
from repro_torch.distributed import ShardingPlan  # noqa: E402
from repro_torch.distributed.context import CountingMesh, shard_context  # noqa: E402
from repro_torch.distributed.sharding import cache_specs, local_shape  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import borda_count as bc  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mlstm_scan as ml  # noqa: E402
from repro_torch.kernels import moe_gating as mg  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.kernels import topk_scores as tk  # noqa: E402
from repro_torch.launch import dryrun as dryrun_mod  # noqa: E402
from repro_torch.launch import pricing as pricing_mod  # noqa: E402
from repro_torch.launch import report as report_mod  # noqa: E402
from repro_torch.launch.mesh import (PEAK_FLOPS, AbstractMesh, make_local_mesh,  # noqa: E402
                                    make_production_mesh)
from repro_torch.launch.specs import cache_specs_for, cell_applicable  # noqa: E402
from repro_torch.models.config import SHAPES, InputShape  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.blocks import _attn_seq, layer_params  # noqa: E402
from repro_torch.models.layers import cut_rows, head_span, rms_norm  # noqa: E402
from repro_torch.serving import BatchScheduler, ServeEngine  # noqa: E402
from repro_torch.serving.engine import PAGED_KERNEL_ATOL, PAGED_KERNEL_RTOL  # noqa: E402
from repro_torch.training import OptimConfig, TrainConfig, Trainer  # noqa: E402
from repro_torch.training.compression import compress_leaf, ef_allreduce  # noqa: E402
from repro_torch.training.fault_tolerance import SimulatedFailure  # noqa: E402
from repro_torch.training.tree import flatten_with_path, leaves, path_str  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# flash and decode attention: the reference's own tolerances (tests/test_kernels.py)
ATT_TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
           torch.bfloat16: dict(atol=3e-2, rtol=0.0)}
# (b, h, kv, hd, bs, nb, maxb): the CPU tests' sweep
SWEEP = [(2, 4, 2, 16, 8, 9, 2), (3, 8, 2, 32, 16, 13, 3), (1, 4, 4, 16, 8, 5, 4),
         (3, 4, 2, 8, 4, 16, 3), (2, 8, 8, 16, 8, 12, 2), (5, 6, 3, 8, 16, 24, 4),
         (2, 4, 4, 64, 16, 9, 3), (2, 8, 2, 128, 16, 9, 3), (3, 4, 2, 16, 1, 40, 9),
         (2, 16, 2, 32, 5, 20, 7)]
# the paged walk's edges (each against the plain version in both types):
# ctx_len 1 on the dummy block 0 (table all zero); ctx_len on a block and on
# a tile boundary (64-row tiles at hd 64, 32 at hd 128); ctx_len = MAXB * bs;
# bs 1 and 5 (blocks that straddle tiles); inf in every K slot and NaN in
# every V slot past ctx_len; G 1, 2, 3, 4, 8 and 16; hd 8 to 128; the block
# ids nearest NB - 1; one row of 4096 tokens
PAGED_EDGES = ([dict(b=2, h=8, kv=2, hd=64, bs=16, nb=20, maxb=4, ctx=[1, 1], table="zero"),
                dict(b=3, h=8, kv=2, hd=64, bs=16, nb=40, maxb=8, ctx=[32, 64, 128]),
                dict(b=2, h=4, kv=1, hd=128, bs=16, nb=40, maxb=8, ctx=[32, 96]),
                dict(b=2, h=8, kv=2, hd=64, bs=16, nb=40, maxb=6, ctx=[96, 96]),
                dict(b=3, h=4, kv=2, hd=32, bs=1, nb=400, maxb=100, ctx=[1, 64, 100]),
                dict(b=3, h=4, kv=2, hd=64, bs=5, nb=100, maxb=20, ctx=[3, 64, 97]),
                dict(b=3, h=16, kv=4, hd=64, bs=16, nb=40, maxb=8, ctx=[20, 77, 128],
                     fill="infnan")]
               + [dict(b=2, h=2 * g, kv=2, hd=64, bs=16, nb=30, maxb=6, ctx=[50, 96])
                  for g in (1, 2, 3, 4, 8, 16)]
               + [dict(b=2, h=8, kv=2, hd=hd, bs=16, nb=30, maxb=6, ctx=[33, 90])
                  for hd in (8, 16, 32, 64, 128)]
               + [dict(b=2, h=8, kv=2, hd=64, bs=16, nb=1000, maxb=8, ctx=[100, 128], table="top"),
                  dict(b=1, h=32, kv=8, hd=128, bs=16, nb=300, maxb=256, ctx=[4096])])
# (b, h, kv, s, hd, window): tests/test_kernels.py's flash sweep (causal)
FLASH_SWEEP = [(2, 4, 2, 128, 64, 0), (1, 4, 4, 256, 32, 0), (2, 8, 2, 128, 64, 64),
               (1, 2, 1, 96, 64, 32), (1, 2, 2, 160, 128, 0)]
# (b, h, kv, sq, sk, hd): its prepended-KV sweep (q_offset = sk - sq)
FLASH_PREPENDED = [(2, 4, 2, 64, 192, 64), (1, 4, 4, 96, 256, 32), (1, 2, 1, 32, 96, 64)]
# (b, h, kv, sq, sk, hd, q_offset, window, causal): the tensor-core path's
# edges: Sq and Sk off the 64-row and 64-key tiles, a window smaller than a
# tile, q_offset off the tile, hd 32 and 128, G 4, a window without causal
FLASH_EDGES = [(1, 4, 2, 100, 100, 64, 0, 0, True), (2, 8, 2, 77, 200, 128, 123, 0, True),
               (1, 4, 4, 300, 300, 64, 0, 17, True), (2, 4, 1, 90, 127, 32, 37, 0, True),
               (1, 8, 2, 129, 193, 128, 64, 70, True), (1, 4, 1, 65, 65, 32, 0, 5, True),
               (1, 4, 2, 70, 150, 64, 0, 40, False), (1, 2, 2, 1, 333, 128, 332, 0, True)]
# (b, h, kv, s, hd, fill): its decode sweep
DECODE_SWEEP = [(2, 8, 2, 256, 64, 256), (1, 4, 4, 128, 128, 100), (2, 4, 1, 96, 64, 50)]
# (b, h, kv, s, hd, slots): the tile walk's edges.  slots: n fills
# slots 0..n-1; ("one", i) fills slot i alone; ("ring", w, (lo, hi)) a ring
# wrapped w slots past its end, slots lo..hi-1 empty; ("ring_infnan", ...)
# the same with inf in the empty slots' K rows and NaN in their V rows
DECODE_EDGES = [(1, 4, 1, 1024, 128, ("one", 777)),     # one valid slot in S 1024
                (1, 4, 1, 4096, 128, 4096),             # B 1 x KV 1: one block, 128 tiles
                (2, 8, 2, 1000, 64, 777),               # S off the tile size
                (2, 8, 2, 512, 128, ("ring", 300, (100, 180))),  # a ring with a hole
                (1, 4, 1, 2048, 64, 0),                 # nothing valid in 32 tiles: 0
                (2, 4, 2, 300, 8, 250), (2, 4, 2, 300, 16, 250),  # hd 8, 16
                (2, 4, 2, 300, 32, 123),                # hd 32
                (2, 16, 2, 700, 128, 600),              # G 8
                (1, 12, 2, 256, 64, 200), (1, 24, 2, 256, 64, 200),  # G 6, G 12
                (2, 8, 2, 1024, 128, ("ring_infnan", 300, (100, 500)))]
# full-width attention shapes: stablelm-1.6b (G 1) and llama3-8b (G 4)
FULL = {"stablelm-1.6b": dict(h=32, kv=32, hd=64), "llama3-8b": dict(h=32, kv=8, hd=128)}
# the paged kernel also at phi4-mini's group of 3 (phase archs decodes there):
# blocks of GC 4 with one query head masked
PAGED_FULL = dict(FULL, **{"phi4-mini-3.8b": dict(h=24, kv=8, hd=128)})
FULL_ROWS, FULL_BS, FULL_NB, FULL_MAXB = 32, 16, 768, 23
FEW_ROWS = 4  # a few judge rationales decoding together
DECODE_FULL = dict(b=32, s=1024, fill=600)
FLASH_MONOLITHIC = dict(b=1, sq=2048, off=0, sk=2048)
COUNTED = {"paged_attention": pa.paged_attention, "flash_attention": fa.flash_attention,
           "decode_attention": da.decode_attention, "moe_gating": mg.moe_gating,
           "ssm_scan": ss.ssm_scan, "mlstm_scan": ml.mlstm_scan,
           "topk_scores": tk.topk_scores, "borda_count": bc.borda_count}
# the family kernels' tolerances against their plain versions: gating ids and
# ranks exact, gates 1e-6; the scans the reference's own (tests/test_kernels.py)
SCAN_TOL = {"ssm_scan": {torch.float32: dict(atol=1e-4, rtol=0.0),
                         torch.bfloat16: dict(atol=2e-2, rtol=2e-2)},
            "mlstm_scan": {torch.float32: dict(atol=2e-3, rtol=0.0),
                           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}}
# (t, e, k): test_moe_gating's sweep, then a tile boundary and Mixtral's router
GATING_SWEEP = [(100, 8, 2), (256, 16, 4), (40, 4, 1), (2049, 8, 2), (300, 64, 8)]
# (t, e, k, logits): the routes' edges (gating_plan), each in fp32 and bf16:
# T 1; one block's tokens and one past (a cluster of two); T at the
# one-launch limit and one past it (a grid whose last block holds one
# token); E 1, k 1; E 256, k 8 in one block, in a full cluster and on the
# grid; rows with every expert tied (so ties in bf16 too); every token's
# first choice on one expert; Mixtral's router over a 16 x 2048 prefill
GATING_EDGES = [(1, 8, 2, "random"), (256, 8, 2, "random"), (257, 8, 2, "random"),
                (mg.one_launch_limit(8, 2), 8, 2, "random"),
                (mg.one_launch_limit(8, 2) + 1, 8, 2, "random"), (300, 1, 1, "random"),
                (64, 256, 8, "random"), (mg.one_launch_limit(256, 8), 256, 8, "random"),
                (600, 256, 8, "random"), (4096, 8, 2, "tied"),
                (mg.one_launch_limit(8, 2) + 256, 8, 1, "one_expert"), (32768, 8, 2, "random")]
# Mixtral's router over a prefill of 16 rows of 2048 tokens: the grid route
GATING_PREFILL = dict(t=32768, e=8, k=2)
# (b, s, d, n): test_ssm_scan's sweep, then every built state size, a ragged D
SSM_SWEEP = [(2, 128, 64, 16), (1, 64, 128, 8), (1, 48, 200, 4), (2, 40, 96, 32),
             (1, 33, 130, 64)]
# (b, s, d, n, inputs): the kernel's edges, each in fp32 and bf16: S 1 and
# one past the staging depth; D 1 and 1601 (no 16-byte rows: copies of one
# value); N 4 and 64 at B 16; dt * a so negative that every decay flushes to 0;
# a = 0; one sequence of x all 0
SSM_EDGES = [(2, 1, 64, 16, "std"), (2, ss.STEPS + 1, 64, 16, "std"), (3, 40, 1, 16, "std"),
             (2, 40, 1601, 16, "std"), (16, 64, 96, 4, "std"), (16, 64, 96, 64, "std"),
             (2, 64, 128, 16, "flush"), (2, 64, 128, 16, "a_zero"),
             (2, 64, 128, 16, "x_zero")]
# Hymba's layer 0 on the families phase's probe batch (16 x 128 tokens)
HYMBA_LAYER0 = (16, 128, 1600, 16)
# (b, h, s, dqk, dv): test_mlstm_scan's sweep, then the other built qk dims,
# a ragged dv and xLSTM's head shape
MLSTM_SWEEP = [(1, 2, 128, 32, 64), (2, 2, 64, 16, 16), (1, 1, 40, 8, 100),
               (1, 2, 24, 64, 64), (1, 1, 24, 128, 72), (1, 2, 48, 256, 512)]
# (b, h, s, dqk, dv, gates): the chunkwise kernel's edges (chunks of
# ml.CHUNK = 64 steps): S 1, T - 1, T, T + 1, 2T + 5; dv 72 and 100 (a
# ragged column tile; rows of 100 the wrapper pads to 104 for the TMA
# boxes); each qk dim (below 64 padded to 64); the stabiliser's paths:
# forget gates far negative with input gates large, and input gates so low
# that every row's stabiliser sits on the -50 floor
MLSTM_EDGES = ([(1, 2, s, 64, 64, "std") for s in (1, 63, 64, 65, 133)]
               + [(1, 2, 100, 32, 72, "std"), (1, 2, 100, 32, 100, "std")]
               + [(1, 2, 70, d, 64, "std") for d in ml.SUPPORTED_QK_DIMS]
               + [(2, 2, 130, 64, 64, "forget"), (2, 2, 130, 64, 64, "floor")])
# the kernels against mlstm_chunkwise_plain: bf16 computes its algebra with
# the operands it makes kept to about 16 bits (two bf16 each), so half of
# SCAN_TOL's bf16 bound (what stays is mostly h's own rounding to bf16, one
# step of 2^-8 where the two land on either side); fp32 steps per position,
# so the reference's own 2e-3 between the two forms
CHUNK_TOL = {torch.float32: dict(atol=2e-3, rtol=0.0),
             torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
# full-width shapes when phase families did not run: Mixtral's router on
# 16 x 256 tokens, Hymba's SSM on 8 x 1024, xLSTM's mLSTM on 8 x 4 heads x 256
FALLBACK_FAMILY = dict(moe_logits=(4096, 8), ssm=(8, 1024, 1600, 16),
                       mlstm=(8, 4, 256, 256, 512))
# (n, k, block_n): test_topk's sweep, a tile that is not a power of two, a
# ragged last tile, k above block_n, the largest tile; then the large shape
TOPK_SWEEP = [(1000, 10, 256), (4096, 16, 1024), (77, 5, 64), (128, 1, 32), (3, 5, 1024),
              (1100, 7, 512), (20, 40, 16), (5000, 300, 8192)]
TOPK_LARGE = dict(n=1 << 20, k=64, block_n=1024)
# (r, s, n): test_borda's sweep, ids past n_items, a wide ballot; then the
# large shape: 4096 ballots of 64 over 1024 items (8.5 M points in all)
BORDA_SWEEP = [(6, 20, 20), (3, 10, 50), (9, 15, 130), (1, 5, 5), (4, 12, 8), (2, 64, 300)]
# (r, s, n, ids): the routes' edges, ballots drawn from ids ids (those >= n
# count nothing): n_items at and one past the one-block limit; R * S at the
# one-block slot limit and one ballot past it; one ballot of 65535 and of
# 65536 slots, points up to S (the plain version's one-hot stays small);
# ids up to twice n_items
BORDA_EDGES = [(64, 64, bc.BLOCK_ITEMS, bc.BLOCK_ITEMS),
               (64, 64, bc.BLOCK_ITEMS + 1, bc.BLOCK_ITEMS + 1),
               (bc.ONE_BLOCK_SLOTS // 64, 64, 100, 100),
               (bc.ONE_BLOCK_SLOTS // 64 + 1, 64, 100, 100),
               (1, 65535, 64, 65535), (1, 65536, 64, 65536),
               (2048, 64, 500, 1000), (16, 32, 20, 40)]
BORDA_LARGE = dict(r=4096, s=64, n=1024)
# 2^22 permutations of 8: each item's points sum to about 1.9e7, past 2^24
BORDA_PAST_2_24 = (1 << 22, 8)
# shapes when phase train did not run: ten pointwise scores, eight ballots of eight
FALLBACK_TRAIN = dict(scores=10, k=5, ballots=(8, 8))


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def reset_launches() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


# ------------------------------------------------------------------ kernels
def randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device=device, dtype=dtype)


def paged_case(seed, b, h, kv, hd, bs, nb, maxb, dtype, device, ctx=None):
    """Random pool (stale values everywhere), distinct non-dummy blocks per
    row, 0-padded tables, ragged context lengths."""
    rng = np.random.default_rng(seed)
    q, kp, vp = (randn(rng, s, dtype, device) for s in
                 ((b, h, hd), (nb, bs, kv, hd), (nb, bs, kv, hd)))
    ids = rng.permutation(np.arange(1, nb))[: b * maxb].reshape(b, maxb)
    if ctx is None:
        n_blk = rng.integers(1, maxb + 1, size=b)
        ctx = (n_blk - 1) * bs + rng.integers(1, bs + 1, size=b)
    ctx = np.asarray(ctx)
    n_blk = -(-ctx // bs)
    tables = np.where(np.arange(maxb)[None, :] < n_blk[:, None], ids, 0)
    return (q, kp, vp, torch.from_numpy(tables.astype(np.int32)).to(device),
            torch.from_numpy(ctx.astype(np.int32)).to(device))


def paged_edge_case(seed, e, dtype, device):
    """paged_case for a PAGED_EDGES entry."""
    b, maxb, nb, bs = e["b"], e["maxb"], e["nb"], e["bs"]
    q, kp, vp, tables, ctx = paged_case(seed, b, e["h"], e["kv"], e["hd"], bs, nb, maxb, dtype,
                                        device, ctx=e["ctx"])
    live = tables != 0
    if e.get("table") == "zero":
        tables = torch.zeros_like(tables)
    elif e.get("table") == "top":
        top = nb - 1 - torch.arange(b * maxb, dtype=torch.int32, device=device).reshape(b, maxb)
        tables = torch.where(live, top, tables)
    if e.get("fill") == "infnan":
        stale = torch.ones(nb, bs, dtype=torch.bool, device=device)
        for r, n in enumerate(e["ctx"]):
            p = torch.arange(n, device=device)
            stale[tables[r, p // bs].long(), p % bs] = False
        kp[stale] = math.inf
        vp[stale] = math.nan
    return q, kp, vp, tables, ctx


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(got, want, dtype, what, tol=TOL) -> float:
    torch.testing.assert_close(got.float(), want.float(), msg=lambda m: f"{what}: {m}",
                               **tol[dtype])
    return max_err(got, want)


def time_ms(fn, flush, reps=15) -> float:
    """Median over ``reps`` single launches by CUDA events, L2 evicted before
    each by reading ``flush`` (256 MB, five times L2): a caller finds its
    inputs cold (in the decode step every layer reads its own arena).  The
    flush reads and writes nothing back, so the dirty lines of the last
    launch are written back during the flush, not inside the timed window."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.sum(dtype=torch.int64)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def summary(name, source, replaces, path, shapes) -> dict:
    """One entry of the kernels line: the first full-width shape's numbers at
    the top level, every shape under ``shapes``."""
    return dict(name=name, route="cuda", source=source, replaces=replaces, path=path,
                shapes=shapes, **{k: shapes[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                            "bound_ms", "bound_by", "library_ms")})


def paged_full_width(arch, d, ctx, dtype, device, flush) -> dict:
    """paged_attention at one full-width attention shape: checked, timed."""
    rows = len(ctx)
    args = paged_case(11, rows, d["h"], d["kv"], d["hd"], FULL_BS, FULL_NB, FULL_MAXB, dtype,
                      device, ctx=ctx)
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    err = check_close(got, pa.paged_attention_plain(*args), dtype,
                      f"paged_attention {arch} B{rows} {dtype}")
    # the larger of bytes over the memory rate and the multiply-adds of q.k
    # and p.v over the valid tokens, as operations, over the peak
    t_bytes = pa.bound_ms(ctx, FULL_BS, d["h"], d["kv"], d["hd"], args[0].element_size())
    t_ops = 1e3 * int(ctx.sum()) * d["h"] * d["hd"] * 2 * 2 / PEAK_FLOPS[dtype]
    bound, by = max((t_bytes, "bytes"), (t_ops, "operations"))
    # what a plain streaming read of as many bytes as the valid K and V rows
    # reaches under the same timing
    flat = torch.ones(2 * int(ctx.sum()) * d["kv"] * d["hd"], dtype=dtype, device=device)
    stream_ms = time_ms(lambda: flat.sum(dtype=torch.float32), flush)
    del flat
    rec = dict(shape=f"{arch} B{rows} H{d['h']} KV{d['kv']} hd{d['hd']} "
                     f"bs{FULL_BS} ctx<= {int(ctx.max())} mean {float(ctx.mean()):.0f}",
               dtype=dtype_name(dtype), max_abs_err=err,
               ms=time_ms(lambda: pa.paged_attention(*args), flush),
               plain_ms=time_ms(lambda: pa.paged_attention_plain(*args), flush),
               bound_ms=bound, bound_by=by, library_ms=None, stream_read_ms=stream_ms)
    say("kernels.full_width", kernel="paged_attention", **rec)
    return rec


def kernel_paged(device, flush) -> dict:
    """paged_attention against paged_attention_plain on the card."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, shape in enumerate(SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            args = paged_case(i, *shape, dtype, device)
            got = pa.paged_attention(*args)
            torch.cuda.synchronize()
            err = check_close(got, pa.paged_attention_plain(*args), dtype,
                              f"paged_attention {shape} {dtype}")
            worst[dtype] = max(worst[dtype], err)
    edges = []
    for i, e in enumerate(PAGED_EDGES):
        rec = dict(edge=e)
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_edge_case(200 + i, e, dtype, device)
            got = pa.paged_attention(*args)
            torch.cuda.synchronize()
            err = check_close(got, pa.paged_attention_plain(*args), dtype,
                              f"paged_attention edge {e} {dtype}")
            worst[dtype] = max(worst[dtype], err)
            rec[f"max_abs_err_{dtype_name(dtype)}"] = err
        edges.append(rec)
    say("kernels.sweep", kernel="paged_attention", shapes=len(SWEEP) + len(PAGED_EDGES),
        max_abs_err_fp32=worst[torch.float32], max_abs_err_bf16=worst[torch.bfloat16],
        tol_fp32=TOL[torch.float32], tol_bf16=TOL[torch.bfloat16], edges=edges)

    rng = np.random.default_rng(7)
    ctx = rng.integers(17, FULL_MAXB * FULL_BS + 1, size=FULL_ROWS)
    ctx[0] = FULL_MAXB * FULL_BS
    shapes = []
    for rows in (FULL_ROWS, FEW_ROWS):
        for arch, d in PAGED_FULL.items():
            for dtype in (torch.bfloat16, torch.float32):
                shapes.append(paged_full_width(arch, d, ctx[:rows], dtype, device, flush))
    return summary("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
                   "src/repro/kernels/paged_attention.py:68", "order_by", shapes)


def flash_inputs(seed, b, h, kv, sq, sk, hd, dtype, device):
    rng = np.random.default_rng(seed)
    return (randn(rng, (b, h, sq, hd), dtype, device), randn(rng, (b, kv, sk, hd), dtype, device),
            randn(rng, (b, kv, sk, hd), dtype, device))


def sdpa_flash(q, k, v, *, causal, q_offset):
    """The yardstick: one PyTorch call computing the same function."""
    sq, sk = q.shape[2], k.shape[2]
    gqa = q.shape[1] != k.shape[1]
    if causal and q_offset == 0 and sq == sk:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=gqa)
    mask = fa.attention_mask(sq, sk, causal=causal, window=0, q_offset=q_offset,
                             device=q.device)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=gqa)


def kernel_flash(device, flush, cont_shapes) -> dict:
    """flash_attention against flash_attention_plain on the card: the sweep,
    the prepended-KV identity, then timings at full width."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (b, h, kv, s, hd, win) in enumerate(FLASH_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(i, b, h, kv, s, s, hd, dtype, device)
            got = fa.flash_attention(q, k, v, causal=True, window=win)
            torch.cuda.synchronize()
            err = check_close(got, fa.flash_attention_plain(q, k, v, causal=True, window=win),
                              dtype, f"flash_attention {(b, h, kv, s, hd, win)} {dtype}", ATT_TOL)
            worst[dtype] = max(worst[dtype], err)
    bitwise = True
    for i, (b, h, kv, sq, sk, hd) in enumerate(FLASH_PREPENDED):
        for dtype in (torch.float32, torch.bfloat16):
            off = sk - sq
            q_full, k, v = flash_inputs(100 + i, b, h, kv, sk, sk, hd, dtype, device)
            q = q_full[:, :, off:].contiguous()
            got = fa.flash_attention(q, k, v, causal=True, q_offset=off)
            mono = fa.flash_attention(q_full, k, v, causal=True)[:, :, off:]
            torch.cuda.synchronize()
            what = f"flash_attention prepended {(b, h, kv, sq, sk, hd)} {dtype}"
            err = check_close(got, fa.flash_attention_plain(q, k, v, causal=True, q_offset=off),
                              dtype, what, ATT_TOL)
            check_close(got, mono, dtype, what + " vs monolithic suffix", ATT_TOL)
            bitwise &= bool(torch.equal(got, mono))
            worst[dtype] = max(worst[dtype], err)
    for i, (b, h, kv, sq, sk, hd, off, win, causal) in enumerate(FLASH_EDGES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(200 + i, b, h, kv, sq, sk, hd, dtype, device)
            kw = dict(causal=causal, window=win, q_offset=off)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = check_close(got, fa.flash_attention_plain(q, k, v, **kw), dtype,
                              f"flash_attention edge {FLASH_EDGES[i]} {dtype}", ATT_TOL)
            worst[dtype] = max(worst[dtype], err)
    say("kernels.sweep", kernel="flash_attention",
        shapes=len(FLASH_SWEEP) + len(FLASH_PREPENDED) + len(FLASH_EDGES),
        max_abs_err_fp32=worst[torch.float32], max_abs_err_bf16=worst[torch.bfloat16],
        tol_fp32=ATT_TOL[torch.float32], tol_bf16=ATT_TOL[torch.bfloat16],
        prepended_equals_monolithic_suffix_bitwise=bitwise)

    shapes = []
    for arch, d in FULL.items():
        for tag, s in cont_shapes + [("monolithic causal", FLASH_MONOLITHIC)]:
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = flash_inputs(13, s["b"], d["h"], d["kv"], s["sq"], s["sk"], d["hd"],
                                       dtype, device)
                kw = dict(causal=True, q_offset=s["off"])
                got = fa.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                what = f"flash_attention {arch} {tag} {dtype}"
                err = check_close(got, fa.flash_attention_plain(q, k, v, **kw), dtype, what,
                                  ATT_TOL)
                lib = sdpa_flash(q, k, v, **kw)
                bound, by = fa.bound_ms(s["b"], d["h"], d["kv"], s["sq"], s["sk"], d["hd"],
                                        dtype, **kw)
                rec = dict(shape=f"{arch} {tag}: B{s['b']} H{d['h']} KV{d['kv']} hd{d['hd']} "
                                 f"Sq{s['sq']} q_offset{s['off']} Sk{s['sk']} causal",
                           dtype=dtype_name(dtype), max_abs_err=err,
                           ms=time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush),
                           plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                                            flush),
                           bound_ms=bound, bound_by=by,
                           library_ms=time_ms(lambda: sdpa_flash(q, k, v, **kw), flush),
                           library_max_abs_err=max_err(lib, got))
                say("kernels.full_width", kernel="flash_attention", **rec)
                shapes.append(rec)
    return summary("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:86", "kernels.ops", shapes)


def decode_inputs(seed, b, h, kv, s, hd, fill, dtype, device):
    rng = np.random.default_rng(seed)
    pos = np.where(np.arange(s) < fill, np.arange(s), -1).astype(np.int32)
    return (randn(rng, (b, h, hd), dtype, device), randn(rng, (b, s, kv, hd), dtype, device),
            randn(rng, (b, s, kv, hd), dtype, device), torch.from_numpy(pos).to(device))


def decode_edge_inputs(seed, b, h, kv, s, hd, slots, dtype, device):
    """decode_inputs with the slots of a DECODE_EDGES entry."""
    if isinstance(slots, int):
        return decode_inputs(seed, b, h, kv, s, hd, slots, dtype, device)
    q, kc, vc, _ = decode_inputs(seed, b, h, kv, s, hd, s, dtype, device)
    idx = np.arange(s)
    if slots[0] == "one":
        pos = np.where(idx == slots[1], 5000, -1)
    else:
        wrap, (lo, hi) = slots[1], slots[2]
        pos = np.where(idx < wrap, idx + s, idx)    # slot j holds the last position = j mod s
        pos[lo:hi] = -1
    pos = torch.from_numpy(pos.astype(np.int32)).to(device)
    if slots[0] == "ring_infnan":
        kc[:, pos < 0] = math.inf
        vc[:, pos < 0] = math.nan
    return q, kc, vc, pos


def sdpa_decode(q, kc, vc, pos):
    """The yardstick: one PyTorch call on the same inputs (cache views)."""
    out = F.scaled_dot_product_attention(
        q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=(pos >= 0)[None, None, None, :], enable_gqa=q.shape[1] != kc.shape[2])
    return out[:, :, 0]


def kernel_decode(device, flush) -> dict:
    """decode_attention against decode_attention_plain on the card."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (b, h, kv, s, hd, fill) in enumerate(DECODE_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            args = decode_inputs(i, b, h, kv, s, hd, fill, dtype, device)
            got = da.decode_attention(*args)
            torch.cuda.synchronize()
            err = check_close(got, da.decode_attention_plain(*args), dtype,
                              f"decode_attention {(b, h, kv, s, hd, fill)} {dtype}", ATT_TOL)
            worst[dtype] = max(worst[dtype], err)
    # a cache with no occupied slot gives 0, as the reference's kernel does
    args = decode_inputs(9, 2, 8, 2, 96, 64, 0, torch.float32, device)
    empty = da.decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(empty, torch.zeros_like(empty)), "an empty cache did not give 0"
    edges = []
    for i, (b, h, kv, s, hd, slots) in enumerate(DECODE_EDGES):
        rec = dict(shape=[b, h, kv, s, hd], slots=slots)
        for dtype in (torch.bfloat16, torch.float32):
            args = decode_edge_inputs(300 + i, b, h, kv, s, hd, slots, dtype, device)
            got = da.decode_attention(*args)
            torch.cuda.synchronize()
            err = check_close(got, da.decode_attention_plain(*args), dtype,
                              f"decode_attention edge {DECODE_EDGES[i]} {dtype}", ATT_TOL)
            if not bool((args[3] >= 0).any()):
                assert torch.equal(got, torch.zeros_like(got)), f"edge {DECODE_EDGES[i]}: not 0"
            worst[dtype] = max(worst[dtype], err)
            rec[f"max_abs_err_{dtype_name(dtype)}"] = err
        edges.append(rec)
    say("kernels.sweep", kernel="decode_attention", shapes=len(DECODE_SWEEP) + len(DECODE_EDGES),
        max_abs_err_fp32=worst[torch.float32], max_abs_err_bf16=worst[torch.bfloat16],
        tol_fp32=ATT_TOL[torch.float32], tol_bf16=ATT_TOL[torch.bfloat16],
        empty_cache_gives_zero=True, edges=edges)

    shapes = []
    b, s, fill = DECODE_FULL["b"], DECODE_FULL["s"], DECODE_FULL["fill"]
    for arch, d in FULL.items():
        for dtype in (torch.bfloat16, torch.float32):
            args = decode_inputs(17, b, d["h"], d["kv"], s, d["hd"], fill, dtype, device)
            got = da.decode_attention(*args)
            torch.cuda.synchronize()
            err = check_close(got, da.decode_attention_plain(*args), dtype,
                              f"decode_attention {arch} {dtype}", ATT_TOL)
            lib = sdpa_decode(*args)
            t_bytes = da.bound_ms(fill, b, d["h"], d["kv"], s, d["hd"], args[0].element_size())
            t_ops = 1e3 * 4 * d["hd"] * fill * b * d["h"] / PEAK_FLOPS[dtype]
            bound, by = max((t_bytes, "bytes"), (t_ops, "operations"))
            # what a plain streaming read of as many bytes as the valid K and
            # V rows reaches under the same timing
            flat = torch.ones(2 * fill * b * d["kv"] * d["hd"], dtype=dtype, device=device)
            stream_ms = time_ms(lambda: flat.sum(dtype=torch.float32), flush)
            del flat
            rec = dict(shape=f"{arch} B{b} H{d['h']} KV{d['kv']} hd{d['hd']} S{s} valid{fill}",
                       dtype=dtype_name(dtype), max_abs_err=err,
                       ms=time_ms(lambda: da.decode_attention(*args), flush),
                       plain_ms=time_ms(lambda: da.decode_attention_plain(*args), flush),
                       bound_ms=bound, bound_by=by,
                       library_ms=time_ms(lambda: sdpa_decode(*args), flush),
                       library_max_abs_err=max_err(lib, got), stream_read_ms=stream_ms)
            say("kernels.full_width", kernel="decode_attention", **rec)
            shapes.append(rec)
    return summary("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:58", "kernels.ops", shapes)


def gating_check(logits, k, what) -> float:
    """The kernel against its plain version: ids and ranks exact, gates to
    1e-6.  Returns the gates' largest error."""
    idx, gates, pos = mg.moe_gating(logits, k)
    torch.cuda.synchronize()
    p_idx, p_gates, p_pos = mg.moe_gating_plain(logits, k)
    assert torch.equal(idx, p_idx), f"{what}: expert ids differ from the plain version"
    assert torch.equal(pos, p_pos), f"{what}: arrival ranks differ from the plain version"
    err = max_err(gates, p_gates)
    assert err <= 1e-6, f"{what}: gates differ by {err}"
    return err


def gating_edge_logits(seed, t, e, kind, dtype, device):
    lg = randn(np.random.default_rng(seed), (t, e), torch.float32, device)
    if kind == "tied":
        lg[:] = 0.5
    elif kind == "one_expert":
        lg[:, -1] = 10.0
    return lg.to(dtype)


def kernel_moe_gating(device, flush, fam) -> dict:
    """moe_gating against moe_gating_plain on the card: the sweep, ties, the
    routes' edges, then Mixtral's router logits from phase families and over
    a 16 x 2048 prefill."""
    worst = 0.0
    for i, (t, e, k) in enumerate(GATING_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            lg = randn(np.random.default_rng(30 + i), (t, e), dtype, device)
            worst = max(worst, gating_check(lg, k, f"moe_gating {(t, e, k)} {dtype}"))
    ties = randn(np.random.default_rng(39), (512, 8), torch.bfloat16, device).float()
    ties[:64] = 0.5                            # all eight experts tied
    ties[64:128, ::2] = 2.0                    # four-way ties at the top
    worst = max(worst, gating_check(ties, 2, "moe_gating ties"))
    assert mg.moe_gating(ties, 2)[0][0].tolist() == [0, 1], "a tie went to a higher index"
    edges = []
    for i, (t, e, k, kind) in enumerate(GATING_EDGES):
        for dtype in (torch.float32, torch.bfloat16):
            lg = gating_edge_logits(130 + i, t, e, kind, dtype, device)
            worst = max(worst, gating_check(lg, k, f"moe_gating edge {(t, e, k, kind)} {dtype}"))
        edges.append(dict(t=t, e=e, k=k, logits=kind, plan=mg.gating_plan(t, e, k)._asdict()))
    say("kernels.sweep", kernel="moe_gating", shapes=len(GATING_SWEEP) + 1 + len(GATING_EDGES),
        max_abs_err_gates=worst, ids_and_ranks_exact=True, tol_gates=1e-6, edges=edges)

    if fam:
        cases = [(fam["tag"], fam["logits"], fam["k"])]
    else:
        cases = [("fixed (phase families did not run)",
                  randn(np.random.default_rng(40), FALLBACK_FAMILY["moe_logits"], torch.float32,
                        device), 2)]
    g = GATING_PREFILL
    cases.append(("Mixtral router, prefill 16 x 2048 (seeded)",
                  randn(np.random.default_rng(41), (g["t"], g["e"]), torch.float32, device),
                  g["k"]))
    shapes = []
    for tag, logits, k in cases:
        t, e = logits.shape
        err = gating_check(logits, k, f"moe_gating {tag}")
        bound, by = mg.bound_ms(t, e, k, logits.element_size())
        rec = dict(shape=f"{tag}: T{t} E{e} k{k}", route=mg.gating_plan(t, e, k).route,
                   dtype=dtype_name(logits.dtype), max_abs_err=err,
                   ms=time_ms(lambda: mg.moe_gating(logits, k), flush),
                   plain_ms=time_ms(lambda: mg.moe_gating_plain(logits, k), flush),
                   bound_ms=bound, bound_by=by, library_ms=None)
        say("kernels.full_width", kernel="moe_gating", **rec)
        shapes.append(rec)
    return summary("moe_gating", "src/repro_torch/kernels/csrc/moe_gating.cu",
                   "src/repro/kernels/moe_gating.py:65", "families", shapes)


def ssm_inputs(seed, b, s, d, n, dtype, device):
    """As tests/test_kernels.py: dt a small positive softplus, a negative."""
    rng = np.random.default_rng(seed)
    x = randn(rng, (b, s, d), dtype, device)
    dt = F.softplus(randn(rng, (b, s, d), torch.float32, device)) * 0.2
    b_t, c_t = (randn(rng, (b, s, n), torch.float32, device) for _ in range(2))
    a = -randn(rng, (d, n), torch.float32, device).abs()
    return x, dt, b_t, c_t, a


def ssm_edge_inputs(seed, b, s, d, n, kind, dtype, device):
    """ssm_inputs ("std"), then: dt + 1 and a - 100 ("flush": every
    dt * a log2 e is under -126, so every decay flushes to 0; y stays under
    about 100, where fp32 keeps 1e-4), a = 0, or x = 0 for the whole first
    sequence."""
    x, dt, b_t, c_t, a = ssm_inputs(seed, b, s, d, n, dtype, device)
    if kind == "flush":
        dt, a = dt + 1.0, a - 100.0
        assert (dt[..., None] * (a * ss.LOG2E) < -126).all()
    elif kind == "a_zero":
        a = torch.zeros_like(a)
    elif kind == "x_zero":
        x[0] = 0
    return x, dt, b_t, c_t, a


def kernel_ssm(device, flush, fam) -> dict:
    """ssm_scan against ssm_scan_plain and ssm_scan_exp2_plain (the bf16
    kernel's arithmetic) on the card: the sweep and the edges, then Hymba's
    layer-0 tensors from phase families with x in bf16 (as the model holds
    x_c) and in fp32."""
    tol = SCAN_TOL["ssm_scan"]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = ([(50 + i, *shape, "std") for i, shape in enumerate(SSM_SWEEP)]
             + [(150 + i, *e) for i, e in enumerate(SSM_EDGES)])
    for seed, b, s, d, n, kind in cases:
        what = f"ssm_scan {(b, s, d, n, kind)}"
        for dtype in (torch.float32, torch.bfloat16):
            args = ssm_edge_inputs(seed, b, s, d, n, kind, dtype, device)
            got = ss.ssm_scan(*args, block_d=d, chunk=s)
            torch.cuda.synchronize()
            err = check_close(got, ss.ssm_scan_plain(*args), dtype, f"{what} {dtype}", tol)
            check_close(got, ss.ssm_scan_exp2_plain(*args), dtype, f"{what} {dtype} vs exp2",
                        tol)
            if kind == "x_zero":
                assert not got[0].any(), f"{what} {dtype}: y of a sequence of x = 0 is not 0"
            worst[dtype] = max(worst[dtype], err)
    say("kernels.sweep", kernel="ssm_scan", shapes=len(cases),
        edges=[dict(zip(("b", "s", "d", "n", "inputs"), e)) for e in SSM_EDGES],
        max_abs_err_fp32=worst[torch.float32], max_abs_err_bf16=worst[torch.bfloat16],
        tol_fp32=tol[torch.float32], tol_bf16=tol[torch.bfloat16])

    if fam:
        base, tag = [fam[k] for k in ("x", "dt", "b_t", "c_t", "a")], fam["tag"]
    else:
        base = list(ssm_inputs(59, *FALLBACK_FAMILY["ssm"], torch.bfloat16, device))
        tag = "fixed (phase families did not run)"
    shapes = []
    for dtype in (torch.bfloat16, torch.float32):
        args = [base[0].to(dtype)] + base[1:]
        b, s, d = args[0].shape
        n = args[4].shape[1]
        got = ss.ssm_scan(*args, block_d=d, chunk=s)
        torch.cuda.synchronize()
        err = check_close(got, ss.ssm_scan_plain(*args), dtype, f"ssm_scan {tag} {dtype}", tol)
        bound, by = ss.bound_ms(b, s, d, n, args[0].element_size())
        rec = dict(shape=f"{tag}: B{b} S{s} D{d} N{n}", dtype=dtype_name(dtype),
                   max_abs_err=err, exp_floor_ms=ss.exp_floor_ms(b, s, d, n),
                   ms=time_ms(lambda: ss.ssm_scan(*args, block_d=d, chunk=s), flush),
                   plain_ms=time_ms(lambda: ss.ssm_scan_plain(*args), flush),
                   bound_ms=bound, bound_by=by, library_ms=None)
        say("kernels.full_width", kernel="ssm_scan", **rec)
        shapes.append(rec)
    return summary("ssm_scan", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                   "src/repro/kernels/ssm_scan.py:43", "families", shapes)


# (forget, input) gate shifts: as tests/test_kernels.py (towards remembering);
# forget far negative, input large; input low enough for the -50 floor
MLSTM_GATES = {"std": (2.0, 0.0), "forget": (-8.0, 8.0), "floor": (-3.0, -60.0)}


def mlstm_inputs(seed, b, h, s, dqk, dv, dtype, device, gates="std"):
    """As tests/test_kernels.py: forget gates shifted towards remembering
    (or by MLSTM_GATES[gates])."""
    rng = np.random.default_rng(seed)
    q, k = (randn(rng, (b, h, s, dqk), dtype, device) for _ in range(2))
    v = randn(rng, (b, h, s, dv), dtype, device)
    f_shift, i_shift = MLSTM_GATES[gates]
    i_g = randn(rng, (b, h, s), torch.float32, device) + i_shift
    f_g = randn(rng, (b, h, s), torch.float32, device) + f_shift
    return q, k, v, i_g, f_g


def mlstm_check(args, dtype, what) -> tuple:
    """The kernel against both plain versions: the per-step one within
    SCAN_TOL, the chunkwise one within CHUNK_TOL.  Returns both errors."""
    s = args[0].shape[2]
    got = ml.mlstm_scan(*args, chunk=s)
    torch.cuda.synchronize()
    err = check_close(got, ml.mlstm_scan_plain(*args), dtype, f"mlstm_scan {what} {dtype}",
                      SCAN_TOL["mlstm_scan"])
    err_chunk = check_close(got, ml.mlstm_chunkwise_plain(*args), dtype,
                            f"mlstm_scan {what} {dtype} vs chunkwise", CHUNK_TOL)
    return got, err, err_chunk


def kernel_mlstm(device, flush, fam) -> dict:
    """mlstm_scan against mlstm_scan_plain on the card: the sweep, then
    xLSTM's layer-0 tensors from phase families in bf16 (the model's type)
    and fp32."""
    tol = SCAN_TOL["mlstm_scan"]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_chunk = {torch.float32: 0.0, torch.bfloat16: 0.0}
    edges = []
    for i, shape in enumerate(MLSTM_SWEEP + MLSTM_EDGES):
        rec = dict(shape=list(shape))
        for dtype in (torch.float32, torch.bfloat16):
            args = mlstm_inputs(60 + i, *shape[:5], dtype, device, *shape[5:])
            _, err, err_chunk = mlstm_check(args, dtype, shape)
            worst[dtype] = max(worst[dtype], err)
            worst_chunk[dtype] = max(worst_chunk[dtype], err_chunk)
            rec[f"max_abs_err_{dtype_name(dtype)}"] = [err, err_chunk]
        if i >= len(MLSTM_SWEEP):
            edges.append(rec)
    say("kernels.sweep", kernel="mlstm_scan", shapes=len(MLSTM_SWEEP) + len(MLSTM_EDGES),
        max_abs_err_fp32=worst[torch.float32], max_abs_err_bf16=worst[torch.bfloat16],
        tol_fp32=tol[torch.float32], tol_bf16=tol[torch.bfloat16],
        vs_chunkwise_max_abs_err_fp32=worst_chunk[torch.float32],
        vs_chunkwise_max_abs_err_bf16=worst_chunk[torch.bfloat16],
        chunk_tol_fp32=CHUNK_TOL[torch.float32], chunk_tol_bf16=CHUNK_TOL[torch.bfloat16],
        edges=edges)

    if fam:
        base, tag = [fam[k] for k in ("q", "k", "v", "i_g", "f_g")], fam["tag"]
    else:
        base = list(mlstm_inputs(69, *FALLBACK_FAMILY["mlstm"], torch.bfloat16, device))
        tag = "fixed (phase families did not run)"
    shapes = []
    for dtype in (torch.bfloat16, torch.float32):
        args = [t.to(dtype) for t in base[:3]] + base[3:]
        b, h, s, dqk = args[0].shape
        dv = args[2].shape[-1]
        _, err, err_chunk = mlstm_check(args, dtype, tag)
        bound, by = ml.bound_ms(b, h, s, dqk, dv, dtype)
        rec = dict(shape=f"{tag}: B{b} H{h} S{s} dqk{dqk} dv{dv}", dtype=dtype_name(dtype),
                   max_abs_err=err, max_abs_err_vs_chunkwise=err_chunk,
                   ms=time_ms(lambda: ml.mlstm_scan(*args, chunk=s), flush),
                   plain_ms=time_ms(lambda: ml.mlstm_scan_plain(*args), flush),
                   bound_ms=bound, bound_by=by, library_ms=None)
        say("kernels.full_width", kernel="mlstm_scan", **rec)
        shapes.append(rec)
    return summary("mlstm_scan", "src/repro_torch/kernels/csrc/mlstm_scan.cu",
                   "src/repro/kernels/mlstm_scan.py:73", "families", shapes)


def topk_check(scores, k, block_n, what) -> None:
    """The kernel against its plain version: values and indices exact."""
    vals, idx = tk.topk_scores(scores, k, block_n=block_n)
    torch.cuda.synchronize()
    p_vals, p_idx = tk.topk_scores_plain(scores, k, block_n=block_n)
    assert torch.equal(idx, p_idx), f"{what}: indices differ from the plain version"
    # bit for bit, so that a NaN equals the same NaN
    assert torch.equal(vals.view(torch.int32), p_vals.view(torch.int32)), \
        f"{what}: values differ from the plain version"


def topk_hard_cases(device) -> dict:
    """name -> (scores, k, block_n): inputs that break a selection by ranks
    or by tiles, each held exactly against the plain version."""
    rng = np.random.default_rng(83)
    pick = lambda m, c: torch.from_numpy(rng.choice(m, c, replace=False)).to(device)  # noqa: E731
    n = TOPK_LARGE["n"]
    three = torch.from_numpy(rng.integers(0, 3, n).astype(np.float32)).to(device)
    # 40 fives, then the 64th largest is one of 50 fours over 512 tiles
    tied = -randn(rng, (1 << 16,), torch.float32, device).abs()
    tied[pick(1 << 16, 90)] = torch.tensor([5.0] * 40 + [4.0] * 50, device=device)
    at_neg = torch.full((1000,), -math.inf, device=device)
    at_neg[pick(1000, 30)] = tk.NEG_INF
    at_neg[pick(1000, 5)] = 1.0
    few = torch.full((5000,), -math.inf, device=device)
    few[pick(5000, 7)] = randn(rng, (7,), torch.float32, device)
    big_k = randn(rng, (1 << 17,), torch.float32, device)
    bf16 = randn(rng, (n,), torch.bfloat16, device)      # bf16 holds many ties
    return {"2^20 scores of 3 values": (three, TOPK_LARGE["k"], 1024),
            "the k-th value tied 50 times across 512 tiles": (tied, 64, 128),
            "scores of exactly -3e38 among -inf": (at_neg, 16, 64),
            "7 finite scores over 20 tiles, k 32": (few, 32, 256),
            "k MAX_K, block_n MAX_BLOCK_N": (big_k, tk.MAX_K, tk.MAX_BLOCK_N),
            "2^20 bf16 scores": (bf16, TOPK_LARGE["k"], 1024)}


def kernel_topk(device, flush, path) -> dict:
    """topk_scores against topk_scores_plain on the card: the sweep in fp32
    and bf16, ties, all -inf (the padding quirk), NaN scores (one, a whole
    tile, one in every tile), the hard cases of :func:`topk_hard_cases`;
    then timed on the scores of phase train's
    pointwise query and at 2^20 scores, k 64."""
    for i, (n, k, bn) in enumerate(TOPK_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            sc = randn(np.random.default_rng(70 + i), (n,), dtype, device)
            topk_check(sc, k, bn, f"topk_scores {(n, k, bn)} {dtype}")
    ties = torch.round(randn(np.random.default_rng(79), (3000,), torch.float32, device) * 4) / 4
    topk_check(ties, 32, 256, "topk_scores ties")
    quirk = torch.full((100,), -math.inf, device=device)
    topk_check(quirk, 5, 64, "topk_scores all -inf")
    assert tk.topk_scores(quirk, 5, block_n=64)[1].tolist() == [0, 0, 0, 0, 100]
    # NaN ranks above every number, the lower index first (jnp.argmax's order)
    nan_cases = {"one NaN": [77], "a whole tile of NaN": [5, *range(64, 128)],
                 "NaN in every tile": list(range(0, 300, 50))}
    for what, at in nan_cases.items():
        sc = randn(np.random.default_rng(82), (300,), torch.float32, device)
        sc[at] = math.nan
        topk_check(sc, 8, 64, f"topk_scores {what}")
        assert tk.topk_scores(sc, 8, block_n=64)[1].tolist()[:len(at)] == at[:8], what
    hard = topk_hard_cases(device)
    for what, (sc, k, bn) in hard.items():
        topk_check(sc, k, bn, f"topk_scores {what}")
    say("kernels.sweep", kernel="topk_scores",
        shapes=2 * len(TOPK_SWEEP) + 2 + len(nan_cases) + len(hard),
        values_and_indices_exact=True, padding_quirk_indices=[0, 0, 0, 0, 100],
        nan_cases=list(nan_cases), hard_cases=list(hard))

    if path:
        cases = [(path["tag"], path["scores"], path["k"])]
    else:
        sc = randn(np.random.default_rng(80), (FALLBACK_TRAIN["scores"],), torch.float32, device)
        cases = [("fixed (phase train did not run)", sc, FALLBACK_TRAIN["k"])]
    big = randn(np.random.default_rng(81), (TOPK_LARGE["n"],), torch.float32, device)
    cases.append((f"large: {TOPK_LARGE['n']} scores", big, TOPK_LARGE["k"]))
    shapes = []
    for tag, sc, k in cases:
        n = sc.shape[0]
        topk_check(sc, k, 1024, f"topk_scores {tag}")
        lib_v, _ = torch.topk(sc.float(), k)
        assert torch.equal(lib_v, tk.topk_scores(sc, k)[0]), f"{tag}: torch.topk's values differ"
        bound, by = tk.bound_ms(n, k, sc.element_size())
        rec = dict(shape=f"{tag}: N{n} k{k} block_n 1024", dtype=dtype_name(sc.dtype),
                   max_abs_err=0.0, ms=time_ms(lambda: tk.topk_scores(sc, k), flush),
                   plain_ms=time_ms(lambda: tk.topk_scores_plain(sc, k), flush),
                   bound_ms=bound, bound_by=by,
                   library_ms=time_ms(lambda: torch.topk(sc, k), flush))
        say("kernels.full_width", kernel="topk_scores", **rec)
        shapes.append(rec)
    return summary("topk_scores", "src/repro_torch/kernels/csrc/topk_scores.cu",
                   "src/repro/kernels/topk_scores.py:46", "train.ops", shapes)


def borda_ballots(seed, r, s, n, device, ids=None):
    """tests/test_kernels.py's ballots: permutations of max(ids, s) items
    (ids defaults to n) cut to s, the first ballot truncated with -1 pads."""
    rng = np.random.default_rng(seed)
    ballots = np.stack([rng.permutation(max(ids or n, s))[:s]
                        for _ in range(r)]).astype(np.int32)
    if r > 1:
        ballots[0, -2:] = -1
    return torch.from_numpy(ballots).to(device)


def borda_check(ballots, n, what) -> None:
    """The kernel against its plain version and borda_matrix: exact."""
    got = bc.borda_count(ballots, n)
    torch.cuda.synchronize()
    assert torch.equal(got, bc.borda_count_plain(ballots, n)), f"{what}: differs from plain"
    want = borda_matrix(np.where(ballots.cpu().numpy() < n, ballots.cpu().numpy(), -1), n)
    assert got.cpu().numpy().tolist() == want.tolist(), f"{what}: differs from borda_matrix"


def kernel_borda(device, flush, path) -> dict:
    """borda_count against borda_count_plain on the card: the sweep, sums
    past 2^24, the routes' edges; then timed on phase train's ballots and on
    4096 ballots of 64."""
    for i, (r, s, n) in enumerate(BORDA_SWEEP):
        borda_check(borda_ballots(90 + i, r, s, n, device), n, f"borda_count {(r, s, n)}")
    # sums past 2^24, where fp32 adds stop being exact: the kernel's integer
    # counts give the exact sum rounded once (the plain version's fp32
    # einsum may differ in the last bit, reported, not held)
    r, s = BORDA_PAST_2_24
    gen = torch.Generator(device).manual_seed(97)
    ballots = torch.rand((r, s), generator=gen, device=device).argsort(dim=1).int()
    got = bc.borda_count(ballots, s)
    exact = torch.zeros(s, dtype=torch.int64, device=device).index_add_(
        0, ballots.reshape(-1).long(), torch.arange(s, 0, -1, device=device).repeat(r))
    assert int(exact.max()) > 2 ** 24, exact.tolist()
    assert torch.equal(got, exact.float()), f"borda_count past 2^24: {got} vs {exact}"
    past_2_24 = dict(ballots=[r, s], largest_sum=int(exact.max()),
                     route=bc.borda_plan(r, s, s).route, equals_exact_sum_rounded=True,
                     equals_plain_fp32_einsum=torch.equal(got, bc.borda_count_plain(ballots, s)))
    edges = []
    for i, (r, s, n, ids) in enumerate(BORDA_EDGES):
        borda_check(borda_ballots(110 + i, r, s, n, device, ids=ids), n,
                    f"borda_count edge {BORDA_EDGES[i]}")
        edges.append(dict(ballots=[r, s], n_items=n, ids=ids, route=bc.borda_plan(r, s, n).route))
    say("kernels.sweep", kernel="borda_count", shapes=len(BORDA_SWEEP) + 1 + len(BORDA_EDGES),
        points_exact=True, edges=edges, past_2_24=past_2_24)

    if path:
        cases = [(path["tag"], path["ballots"], path["n_items"])]
    else:
        r, s = FALLBACK_TRAIN["ballots"]
        cases = [("fixed (phase train did not run)", borda_ballots(98, r, s, s, device), s)]
    big = BORDA_LARGE
    cases.append((f"large: {big['r']} ballots of {big['s']}",
                  borda_ballots(99, big["r"], big["s"], big["n"], device), big["n"]))
    shapes = []
    for tag, ballots, n in cases:
        r, s = ballots.shape
        borda_check(ballots, n, f"borda_count {tag}")
        # the yardstick: one index_add_ over the valid slots, mask built outside
        valid = (ballots >= 0) & (ballots < n)
        ids = ballots[valid].long()
        pts = torch.arange(s, 0, -1, dtype=torch.float32, device=device).expand(r, s)[valid]
        lib = torch.zeros(n, device=device).index_add_(0, ids, pts)
        assert torch.equal(lib, bc.borda_count(ballots, n)), f"{tag}: index_add_ differs"
        bound, by = bc.bound_ms(r, s, n)
        rec = dict(shape=f"{tag}: R{r} S{s} n_items {n}", route=bc.borda_plan(r, s, n).route,
                   dtype="int32", max_abs_err=0.0,
                   ms=time_ms(lambda: bc.borda_count(ballots, n), flush),
                   plain_ms=time_ms(lambda: bc.borda_count_plain(ballots, n), flush),
                   bound_ms=bound, bound_by=by,
                   library_ms=time_ms(lambda: torch.zeros(n, device=device).index_add_(
                       0, ids, pts), flush))
        say("kernels.full_width", kernel="borda_count", **rec)
        shapes.append(rec)
    return summary("borda_count", "src/repro_torch/kernels/csrc/borda_count.cu",
                   "src/repro/kernels/borda_count.py:49", "train.ops", shapes)


def launch_floor(device, flush) -> None:
    """The yardstick of the launch-bound rows: ``time_ms`` of an in-place add
    on a one-element tensor, under the same flush."""
    one = torch.zeros(1, device=device)
    ms = time_ms(lambda: one.add_(1), flush)
    say("kernels.full_width", kernel="launch_floor", shape="in-place add on one element",
        dtype="float32", ms=ms, launch_floor_ms=ms, bound_ms=0.0, bound_by="bytes")


def phase_kernels(device, cont_shapes, fam, train_path) -> list:
    flush = torch.ones(256 << 20, dtype=torch.uint8, device=device)  # read by time_ms
    launch_floor(device, flush)
    return [kernel_paged(device, flush), kernel_flash(device, flush, cont_shapes),
            kernel_decode(device, flush), kernel_moe_gating(device, flush, fam.get("moe_gating")),
            kernel_ssm(device, flush, fam.get("ssm_scan")),
            kernel_mlstm(device, flush, fam.get("mlstm_scan")),
            kernel_topk(device, flush, train_path.get("topk_scores")),
            kernel_borda(device, flush, train_path.get("borda_count"))]


def phase_ops(device) -> dict:
    """Kernels 2 and 3 through the entry points the reference reaches them
    by (``kernels/ops.py``), at full-width stablelm shapes in bf16."""
    d = FULL["stablelm-1.6b"]
    q, k, v = flash_inputs(21, 4, d["h"], d["kv"], 64, 256, d["hd"], torch.bfloat16, device)
    dargs = decode_inputs(22, 4, d["h"], d["kv"], 256, d["hd"], 200, torch.bfloat16, device)
    reset_launches()                           # ---- the path starts here
    out_f = ops.flash_attention(q, k, v, causal=True, q_offset=192)
    out_d = ops.decode_attention(*dargs)
    torch.cuda.synchronize()
    launches = read_launches()                 # ---- and ends here
    assert torch.isfinite(out_f.float()).all() and torch.isfinite(out_d.float()).all()
    assert launches["flash_attention"] > 0 and launches["decode_attention"] > 0, launches
    say("ops", launches=launches)
    return launches


# ------------------------------------------------------------- ORDER BY path
PASSAGES = [
    "bmt stands for bone marrow transplant, a medical procedure",
    "the weather in paris is mild in october",
    "bone marrow transplants treat leukemia and lymphoma",
    "bmt is also a subway line in new york city",
    "a transplant replaces damaged marrow with healthy stem cells",
    "stock markets closed higher on tuesday",
    "patients undergoing bmt need immunosuppression",
    "the recipe calls for two cups of flour",
    "marrow donation is coordinated through national registries",
    "football season begins in september",
    "graft-versus-host disease is a bmt complication",
    "the museum opens at nine daily",
]
QUERY = "relevance to query: define bmt medical"
STATIC_PATHS = ("pointwise", "ext_pointwise", "quick", "ext_bubble", "ext_merge")
# one auto query judging its pilots with free-decoded rationales, one static query
QUERIES = [dict(path="auto", strategy="judge", sample_size=8, rationale=16),
           dict(path="ext_merge", rationale=0)]


def ledger_of(o) -> tuple:
    return (o.ledger.n_calls, o.ledger.input_tokens, o.ledger.output_tokens,
            list(o.ledger.records))


def query_kw(qd) -> dict:
    kw = dict(descending=True, limit=5, path=qd["path"])
    if qd["path"] == "auto":
        kw.update(strategy=qd["strategy"], sample_size=qd["sample_size"])
    return kw


def assert_no_leak(eng) -> None:
    assert eng.paged_active == 0, eng.paged_active
    lru = sum(len(e.blocks) for e in eng._prefix_lru.values() if e.blocks is not None)
    assert eng.pool.blocks_in_use == lru, (eng.pool.blocks_in_use, lru)
    eng.clear_prefix_cache()
    assert eng.pool.blocks_in_use == 0, eng.pool.blocks_in_use


def record_prefill_cont(lm, shapes: collections.Counter):
    """Count the (B, Sq, q_offset, Sk) of every ``prefill_cont`` the engine
    issues: the prepended-KV attention shapes of the path."""
    inner = lm.prefill_cont

    def counted(caches, batch, reserve=0):
        b, sq = batch["tokens"].shape
        off = caches[0].k.shape[2]
        shapes[(b, sq, off, off + sq)] += 1
        return inner(caches, batch, reserve=reserve)

    lm.prefill_cont = counted


def solo(eng, keys, qd) -> tuple:
    """One query alone on ``eng``: (result, report, ledger, stats deltas, wall)."""
    o = ModelOracle(eng, judge_rationale_tokens=qd["rationale"])
    st = eng.stats
    before = (st.calls, st.probe_rows, st.decode_tokens)
    t0 = time.perf_counter()
    res, rep = llm_order_by(keys, QUERY, o, **query_kw(qd))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = [a - b for a, b in zip((st.calls, st.probe_rows, st.decode_tokens), before)]
    return res, rep, ledger_of(o), delta, wall


def report_query(tag, qd, res, rep, delta, wall) -> None:
    say(f"order_by.{tag}", path=qd["path"], chosen=rep.chosen.label if rep else None,
        n_calls=res.n_calls, cost=res.cost, submissions=delta[0], probe_rows=delta[1],
        decode_tokens=delta[2], wall_seconds=wall, order=res.uids())


def phase_order_by(device, card, seed) -> tuple:
    """The main path: stablelm-1.6b at full width, bf16, seeded random
    weights, ``ServeEngine(paged_kernel=True)``."""
    cfg = get_config("stablelm-1.6b")
    lm = LM(cfg, device=device, generator=torch.Generator(device).manual_seed(seed))
    keys = as_keys(PASSAGES)
    eng = ServeEngine(lm, paged_kernel=True, max_new_tokens=16)
    cont = collections.Counter()
    record_prefill_cont(lm, cont)

    oracles = [ModelOracle(eng, judge_rationale_tokens=qd["rationale"]) for qd in QUERIES]
    queries = [OrderQuery(keys, QUERY, o, **query_kw(qd)) for qd, o in zip(QUERIES, oracles)]
    st = eng.stats
    before = (st.calls, st.probe_rows, st.decode_tokens)
    reset_launches()                           # ---- the main path starts here
    t0 = time.perf_counter()
    results = llm_order_by_many(queries, scheduler=BatchScheduler(eng))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                 # ---- and ends here
    delta = [a - b for a, b in zip((st.calls, st.probe_rows, st.decode_tokens), before)]
    assert launches["paged_attention"] > 0, launches
    assert_no_leak(eng)
    say("order_by.many", queries=len(queries), submissions=delta[0], probe_rows=delta[1],
        decode_tokens=delta[2], wall_seconds=wall, launches=launches,
        prefill_cont_shapes=[dict(b=b, sq=sq, q_offset=off, sk=sk, count=n)
                             for (b, sq, off, sk), n in cont.most_common()])
    for qd, q, res in zip(QUERIES, queries, results):
        assert len(res.order) == 5 and len(set(res.uids())) == 5, res.uids()
        say("order_by.many.query", path=qd["path"],
            chosen=q.report.chosen.label if q.report else None,
            reason=q.report.reason if q.report else None, n_calls=res.n_calls,
            cost=res.cost, order=res.uids())

    # each query of the shared call equals its solo run: order and ledger
    solo_orders = []
    for qd, q, o, res in zip(QUERIES, queries, oracles, results):
        sres, srep, sledger, sdelta, swall = solo(eng, keys, qd)
        report_query("solo", qd, sres, srep, sdelta, swall)
        assert sres.uids() == res.uids(), (qd["path"], sres.uids(), res.uids())
        assert sledger == ledger_of(o), f"{qd['path']}: ledger differs from its solo run"
        solo_orders.append(sres.uids())
        assert_no_leak(eng)
    say("order_by.many_equals_solo", orders=True, ledgers=True)

    # every static path once through llm_order_by
    for path in STATIC_PATHS:
        qd = dict(path=path, rationale=0)
        res, rep, _, delta, wall = solo(eng, keys, qd)
        assert len(res.order) == 5 and len(set(res.uids())) == 5, res.uids()
        report_query("static", qd, res, rep, delta, wall)
        assert_no_leak(eng)
    say("order_by.serve", card=card, arch=cfg.name, dtype=cfg.dtype,
        layers=cfg.decoder_layers(), stats=dict(vars(eng.stats)),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng

    # the "check" engine: kernel and dense decode side by side, the
    # tolerance asserted inline at every step of the judge's rationales
    check = ServeEngine(lm, paged_kernel="check", max_new_tokens=16)
    cres, _, _, cdelta, _ = solo(check, keys, QUERIES[0])
    assert cdelta[2] > 0, "the check engine decoded no token"
    assert_no_leak(check)
    del check
    # reported, not asserted: the dense engine's orders
    dense = ServeEngine(lm, paged_kernel=False, max_new_tokens=16)
    dense_orders = [solo(dense, keys, qd)[0].uids() for qd in QUERIES]
    assert_no_leak(dense)
    del dense
    say("order_by.check", rtol=PAGED_KERNEL_RTOL, atol=PAGED_KERNEL_ATOL, passed=True,
        decode_tokens=cdelta[2], order_equals_kernel_engine=cres.uids() == solo_orders[0],
        dense_orders_equal={qd["path"]: a == b for qd, a, b in
                            zip(QUERIES, dense_orders, solo_orders)})
    del lm.prefill_cont                        # the shim goes
    picked = [("order_by prefill_cont, most frequent", cont.most_common(1)[0][0]),
              ("order_by prefill_cont, most work", max(cont, key=lambda s: s[0] * s[1] * s[3]))]
    cont_shapes = [(tag, dict(b=b, sq=sq, off=off, sk=sk)) for tag, (b, sq, off, sk) in picked]
    return launches, cont_shapes


# ------------------------------------------- MoE / Hymba / xLSTM families
# (arch, depth or None for the full depth).  mixtral-8x7b's 46.7 B parameters
# (about 93 GB in bf16) do not fit the card's 80 GB: 4 of its 32 layers.
FAMILY_RUNS = [("hymba-1.5b", None), ("xlstm-1.3b", None), ("mixtral-8x7b", 4)]
FAMILY_PATH = "pointwise"
FAMILY_PROMPTS = [("Summarize the following ticket for the on-call engineer.\nTicket: ",
                   "disk 3 on rack 21 reports 6 reallocated sectors"),
                  "Count to ten.", "Write one line about block tables."]
# longer than Hymba's 1024-token window, so the hymba_l rings wrap
LONG_PROMPT = "Summarize this log.\n" + "".join(
    f"step {i}: the scheduler admitted a row and freed two blocks. " for i in range(24))
# Hymba's d_inner 1600 is no multiple of the reference's default block_d 256,
# which its entry would refuse; 320 divides it (the kernel needs neither)
SSM_BLOCK_D = 320
# the kernels against the model path's own results on the same tensors: the
# scans in fp32 sum in other orders (the model's SSM chunk is a log-depth
# scan, its mLSTM chunkwise), so absolute and relative tolerances
MODEL_TOL = {"ssm_scan": dict(atol=1e-4, rtol=1e-4), "mlstm_scan": dict(atol=2e-3, rtol=2e-3)}


def family_config(arch, depth):
    cfg = get_config(arch)
    if depth is None:
        return cfg
    (kind, _), = cfg.pattern
    return dataclasses.replace(cfg, n_layers=depth, pattern=((kind, depth),))


def record_prefills(lm, batches: list):
    """Keep the token batch of every ``prefill`` the engine issues (``del
    lm.prefill`` removes the shim)."""
    inner = lm.prefill

    def counted(batch, reserve=0):
        batches.append(batch["tokens"])
        return inner(batch, reserve=reserve)

    lm.prefill = counted


@torch.inference_mode()
def prefill_decode_rel_err(lm, seed) -> float:
    """The reference's contract (tests/test_models_smoke.py): a 16-position
    prefill plus one decode step against the 17-position forward's last
    logits, relative to their scale, on the inputs that test makes: token
    ids; normal embeddings for an ``embeds`` arch; 8 positions of normal
    encoder input beside the tokens for an encoder-decoder.  Reported, not
    asserted, at full width."""
    cfg = lm.cfg
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 17)).astype(np.int32)).to(lm.device)
    full = {"tokens": toks}
    if cfg.input_mode == "embeds":
        emb = randn(rng, (2, 17, cfg.d_model), torch.bfloat16, lm.device)
        full, pre, step = {"embeds": emb}, {"embeds": emb[:, :16]}, emb[:, 16:]
    else:
        if cfg.input_mode == "encdec":
            full["enc_embeds"] = randn(rng, (2, 8, cfg.d_model), torch.bfloat16, lm.device)
        pre, step = dict(full, tokens=toks[:, :16]), toks[:, 16:]
    x, _ = lm.forward(full, mode="train")
    ref = lm._head(x)[:, -1].float()
    _, caches = lm.prefill(pre, reserve=4)
    logits, _ = lm.decode_step(caches, step, 16)
    assert torch.isfinite(ref).all() and torch.isfinite(logits).all()
    return float((ref - logits.float()).abs().max()) / (float(ref.abs().max()) + 1e-6)


@torch.inference_mode()
def window_wraps(lm, ids) -> dict:
    """Prefill ``ids`` alone and check the first windowed stack's ring: it
    holds exactly the last ``sliding_window`` positions."""
    cfg = lm.cfg
    i = next(i for i, (kind, _) in enumerate(cfg.pattern) if kind == "hymba_l")
    _, caches = lm.prefill({"tokens": torch.tensor([ids], dtype=torch.int32, device=lm.device)})
    kv = caches[i][0]
    s, w = len(ids), cfg.sliding_window
    assert kv.k.shape[2] == w, kv.k.shape
    assert sorted(kv.pos[0].tolist()) == list(range(s - w, s)), "the ring did not wrap"
    return dict(prompt_tokens=s, window=w, ring_holds_last_window=True)


@torch.inference_mode()
def layer0_tensors(lm, toks):
    """What layer 0 feeds its kernel-shaped function on a probe batch,
    computed with the port's own helpers, and the model path's result on
    those tensors: Mixtral's router logits and ``moe_ffn``'s routing of them;
    Hymba's x_c, dt, b_t, c_t, a = -exp(A_log) and the scan's y before the
    gate; xLSTM's q (times sqrt(qk): the model scales q, the kernel scales it
    again), k, v, i, f and the chunkwise h before the group norm."""
    cfg = lm.cfg
    kind = cfg.pattern[0][0]
    p = layer_params(lm.stack_params(0), 0)
    x = lm._embed_in({"tokens": toks})
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    b, s = toks.shape
    if kind in ("moe", "moe_swa"):
        window = cfg.sliding_window if kind == "moe_swa" else 0
        a, _ = _attn_seq(p, h, cfg, lm._angles(None, s, b), window)
        h2 = rms_norm(x + cfg.residual_scale * a, p["norm2"], cfg.norm_eps)
        logits = (h2.reshape(b * s, -1) @ p["moe"]["router"]).float()
        idx, gates, pos = moe_mod.route(logits, cfg.moe.top_k)
        return "moe_gating", dict(logits=logits, k=cfg.moe.top_k), dict(idx=idx, gates=gates,
                                                                          pos=pos)
    if kind in ("hymba_g", "hymba_l"):
        x_c, _ = ssm_mod.ssm_conv_input(p["ssm"], h)
        dt, a, b_t, c_t = ssm_mod._ssm_coeffs(p["ssm"], x_c)
        y, _ = ssm_mod.ssm_scan_chunked(p["ssm"], x_c, cfg.scan_chunk)
        d_x = p["ssm"]["D_skip"] * x_c.float()
        return "ssm_scan", dict(x=x_c.contiguous(), dt=dt, b_t=b_t, c_t=c_t,
                                a=a.contiguous(), d_x=d_x), dict(y=y + d_x)
    q, k, v, i_g, f_g = xlstm_mod._mlstm_qkvif(p, h, cfg.n_heads, cfg.qk, cfg.hd)
    state = xlstm_mod.init_mlstm_state(b, cfg.n_heads, cfg.qk, cfg.hd, lm.device)
    h_pre, _ = xlstm_mod.mlstm_chunkwise(q, k, v, i_g, f_g, cfg.scan_chunk, state)
    # q * sqrt(qk) in fp32: the kernel's own 1 / sqrt(qk) then gives back the
    # model's q (exactly at qk 256, where the scale is 16)
    return "mlstm_scan", dict(q=(q.float() * math.sqrt(cfg.qk)).contiguous(), k=k.contiguous(),
                              v=v.contiguous(), i_g=i_g.contiguous(),
                              f_g=f_g.contiguous()), dict(h=h_pre)


def family_kernel(name, ins, model, tag) -> dict:
    """The family's kernel through ``repro_torch.kernels.ops`` on layer 0's
    tensors, against its plain version and against the model path's own
    result.  The counts are set to 0 just before and read just after."""
    reset_launches()                           # ---- the path starts here
    if name == "moe_gating":
        idx, gates, pos = ops.moe_gating(ins["logits"], ins["k"])
    elif name == "ssm_scan":
        args = (ins["x"].float(), ins["dt"], ins["b_t"], ins["c_t"], ins["a"])
        s = args[0].shape[1]
        y = ops.ssm_scan(*args, block_d=SSM_BLOCK_D, chunk=min(64, s))
    else:
        args = (ins["q"].float(), ins["k"].float(), ins["v"].float(), ins["i_g"], ins["f_g"])
        s = args[0].shape[2]
        h = ops.mlstm_scan(*args, chunk=min(64, s))
        # and in bf16, the type xLSTM serves in: the chunkwise kernel
        args_bf = tuple(t.bfloat16() for t in args[:3]) + args[3:]
        h_bf = ops.mlstm_scan(*args_bf, chunk=min(64, s))
    torch.cuda.synchronize()
    launches = read_launches()                 # ---- and ends here
    assert launches[name] > 0, launches
    if name == "moe_gating":
        p_idx, p_gates, p_pos = mg.moe_gating_plain(ins["logits"], ins["k"])
        assert torch.equal(idx, p_idx) and torch.equal(pos, p_pos), "differs from the plain version"
        assert torch.equal(idx.long(), model["idx"]), "expert ids differ from moe_ffn's"
        assert torch.equal(pos.long(), model["pos"]), "arrival ranks differ from moe_ffn's"
        err_plain, err_model = max_err(gates, p_gates), max_err(gates, model["gates"])
        assert err_plain <= 1e-6 and err_model <= 1e-6, (err_plain, err_model)
        top3 = ins["logits"].sort(dim=-1, descending=True)[0][:, :3]
        extra = dict(ids_and_ranks_equal_moe_ffn=True, tokens=int(idx.shape[0]),
                     rows_with_a_tie_in_top3=int((top3.diff(dim=-1) == 0).any(-1).sum()))
    elif name == "ssm_scan":
        err_plain = check_close(y, ss.ssm_scan_plain(*args), torch.float32, f"ssm_scan {tag}",
                                SCAN_TOL[name])
        torch.testing.assert_close(y + ins["d_x"], model["y"], **MODEL_TOL[name],
                                   msg=lambda m: f"ssm_scan vs ssm_sequence {tag}: {m}")
        err_model = max_err(y + ins["d_x"], model["y"])
        extra = dict(block_d=SSM_BLOCK_D, model_tol=MODEL_TOL[name])
    else:
        err_plain = check_close(h, ml.mlstm_scan_plain(*args), torch.float32,
                                f"mlstm_scan {tag}", SCAN_TOL[name])
        torch.testing.assert_close(h, model["h"], **MODEL_TOL[name],
                                   msg=lambda m: f"mlstm_scan vs mlstm_sequence {tag}: {m}")
        err_model = max_err(h, model["h"])
        err_bf = check_close(h_bf, ml.mlstm_scan_plain(*args_bf), torch.bfloat16,
                             f"mlstm_scan bf16 {tag}", SCAN_TOL[name])
        err_bf_chunk = check_close(h_bf, ml.mlstm_chunkwise_plain(*args_bf), torch.bfloat16,
                                   f"mlstm_scan bf16 {tag} vs chunkwise", CHUNK_TOL)
        extra = dict(model_tol=MODEL_TOL[name], bf16_max_abs_err_vs_plain=err_bf,
                     bf16_max_abs_err_vs_chunkwise=err_bf_chunk)
    say("families.kernel", kernel=name, shape=tag, launches=launches[name],
        max_abs_err_vs_plain=err_plain, max_abs_err_vs_model_path=err_model, **extra)
    return launches


def phase_families(device, card, seed) -> tuple:
    """Hymba, xLSTM and Mixtral (depth cut), one after another, each served
    by ``ServeEngine`` at full width with seeded random bf16 weights, then
    its kernel on layer 0's tensors.  Returns the kernels' launches on this
    path and the tensors, kept for phase kernels."""
    keys = as_keys(PASSAGES)
    launches = collections.Counter()
    fam = {}
    for arch, depth in FAMILY_RUNS:
        cfg = family_config(arch, depth)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        lm = LM(cfg, device=device, generator=torch.Generator(device).manual_seed(seed))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eng = ServeEngine(lm, max_new_tokens=16)
        # recurrent state, ring placement and batch-ranked expert capacity:
        # no prefix KV and no paged pool, as the reference's engine decides
        assert not eng.prefix_cache_enabled and not eng.paged_enabled and eng.pool is None

        batches = []
        record_prefills(lm, batches)
        st = eng.stats
        before = (st.calls, st.probe_rows)
        t1 = time.perf_counter()
        res, _ = llm_order_by(keys, QUERY, ModelOracle(eng), descending=True, limit=5,
                              path=FAMILY_PATH)
        torch.cuda.synchronize()
        query_s = time.perf_counter() - t1
        del lm.prefill                         # the shim goes
        assert len(res.order) == 5 and len(set(res.uids())) == 5, res.uids()
        submissions, probe_rows = st.calls - before[0], st.probe_rows - before[1]

        prompts = list(FAMILY_PROMPTS) + ([LONG_PROMPT] if arch == "hymba-1.5b" else [])
        before = st.decode_tokens
        t1 = time.perf_counter()
        outs = eng.generate(prompts, max_new_per=[16] * len(prompts))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t1
        assert len(outs) == len(prompts) and all(isinstance(o, str) for o in outs)
        window = window_wraps(lm, eng.tok.encode(LONG_PROMPT)) if arch == "hymba-1.5b" else None
        say("families.model", card=card, arch=cfg.name, layers=cfg.decoder_layers(),
            depth_cut=f"{depth} of {get_config(arch).n_layers} layers" if depth else None,
            dtype=cfg.dtype, params=sum(p.numel() for p in lm.parameters()),
            init_seconds=init_s, query_path=FAMILY_PATH, query_wall_seconds=query_s,
            submissions=submissions, probe_rows=probe_rows, n_calls=res.n_calls,
            order=res.uids(), generate_prompts=len(prompts), generate_wall_seconds=gen_s,
            decode_tokens=st.decode_tokens - before, window=window,
            prefill_decode_vs_forward_rel_err=prefill_decode_rel_err(lm, seed),
            wall_seconds=time.perf_counter() - t0,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

        toks = max(batches, key=lambda t: t.numel())
        name, ins, model = layer0_tensors(lm, toks)
        tag = f"{cfg.name} layer 0, probe batch {tuple(toks.shape)}"
        launches.update(family_kernel(name, ins, model, tag))
        fam[name] = dict(ins, tag=tag)
        del eng, lm, model
        torch.cuda.empty_cache()
        # the same contract with the same seed's weights in fp32: how much of
        # the bf16 figure is rounding carried through the layers
        lm32 = LM(dataclasses.replace(cfg, dtype="float32"), device=device,
                  generator=torch.Generator(device).manual_seed(seed))
        say("families.contract", arch=cfg.name,
            prefill_decode_vs_forward_rel_err_fp32=prefill_decode_rel_err(lm32, seed))
        del lm32
        torch.cuda.empty_cache()
    return dict(launches), fam


# ------------------------------------------ the rest of the zoo (archs)
# full width and full depth, seeded random bf16 weights, one after another
ARCH_RUNS = ("phi4-mini-3.8b", "qwen2-vl-7b", "seamless-m4t-medium")
JUDGE = QUERIES[0]                  # auto, judging its pilots with rationales


def arch_query(eng, keys) -> dict:
    """The judged ORDER BY query and a ``generate`` of GEN_PROMPTS on
    ``eng`` (GEN_LIMITS capped at the engine's 16 new tokens): the order,
    the ledger and the engine's deltas."""
    res, rep, ledger, delta, wall = solo(eng, keys, JUDGE)
    assert len(res.order) == 5 and len(set(res.uids())) == 5, res.uids()
    before = eng.stats.decode_tokens
    t0 = time.perf_counter()
    outs = eng.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS)
    torch.cuda.synchronize()
    assert len(outs) == len(GEN_PROMPTS) and all(isinstance(o, str) for o in outs)
    return dict(chosen=rep.chosen.label if rep else None, n_calls=res.n_calls,
                submissions=delta[0], probe_rows=delta[1], query_decode_tokens=delta[2],
                query_wall_seconds=wall, order=res.uids(), ledger=ledger,
                generate_prompts=len(GEN_PROMPTS),
                generate_decode_tokens=eng.stats.decode_tokens - before,
                generate_wall_seconds=time.perf_counter() - t0, outs=outs)


def phi4_qchunk(lm, eng, card) -> None:
    """The same weights as ``attn_impl="qchunk"``: the engine turns the
    prefix cache and the paged pool off; one probe batch's last logits
    against the einsum engine's; a ``generate`` through the lockstep loop."""
    cfg = lm.cfg
    probes = ["".join(eng.score_parts(p, QUERY)) for p in PASSAGES[:8]]
    want = eng.submit_probes(probes)
    lm.cfg = dataclasses.replace(cfg, attn_impl="qchunk")
    try:
        q = ServeEngine(lm, max_new_tokens=16)
        assert not q.prefix_cache_enabled and not q.paged_enabled and q.pool is None
        got = q.submit_probes(probes)
        outs = q.generate(GEN_PROMPTS[:6], max_new_per=GEN_LIMITS[:6])    # lockstep
        torch.cuda.synchronize()
    finally:
        lm.cfg = cfg
    assert len(outs) == 6 and q.stats.decode_tokens > 0
    assert np.isfinite(got).all() and got.shape == want.shape == (8, cfg.vocab_size)
    err = float(np.abs(got - want).max())
    within = bool(np.allclose(got, want, rtol=PAGED_KERNEL_RTOL, atol=PAGED_KERNEL_ATOL))
    say("archs.qchunk", card=card, arch=cfg.name, attn_chunk=cfg.attn_chunk,
        prefix_cache=False, paged_pool=False, probe_rows=len(probes),
        last_logits_max_abs_err_vs_einsum=err, logits_scale=float(np.abs(want).max()),
        bf16_tol=dict(rtol=PAGED_KERNEL_RTOL, atol=PAGED_KERNEL_ATOL), within_bf16_tol=within,
        argmax_agreement=float((got.argmax(-1) == want.argmax(-1)).mean()),
        decode_tokens=q.stats.decode_tokens)


def phase_archs(device, card, seed) -> dict:
    """phi4-mini (G 3, hd 128) through the paged kernel, checked against the
    dense step, then as ``qchunk``; qwen2-vl (M-RoPE, embeds input) and
    seamless (encoder-decoder) through monolithic prefill and the lockstep
    loop.  Each ORDER BY query and ``generate`` runs with the counts set to 0
    just before and read just after; the check engine, which launches the
    kernel to compare it, is not counted.  Returns the launches."""
    keys = as_keys(PASSAGES)
    launches = collections.Counter()
    for arch in ARCH_RUNS:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lm = seeded_lm(get_config(arch), device, seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        extra = {}
        if arch == "phi4-mini-3.8b":
            check = ServeEngine(lm, paged_kernel="check", max_new_tokens=16)
            steps = count_steps(check)
            crun = arch_query(check, keys)
            assert steps["kernel"] == steps["dense"] > 0, steps
            assert_no_leak(check)
            del check
            eng = ServeEngine(lm, paged_kernel=True, max_new_tokens=16)
            assert eng.prefix_cache_enabled and eng.paged_enabled
        else:
            eng = ServeEngine(lm, max_new_tokens=16)
            # embeds / encoder input: no prefix KV and no paged pool, as the
            # reference's engine decides; decode is the lockstep loop
            assert not eng.prefix_cache_enabled and not eng.paged_enabled and eng.pool is None
        reset_launches()                       # ---- the path starts here
        run = arch_query(eng, keys)
        torch.cuda.synchronize()
        mine = read_launches()                 # ---- and ends here
        launches.update(mine)
        if arch == "phi4-mini-3.8b":
            assert mine["paged_attention"] > 0, mine
            assert_no_leak(eng)
            extra = dict(check_engine=dict(steps=steps["kernel"], passed=True,
                                           rtol=PAGED_KERNEL_RTOL, atol=PAGED_KERNEL_ATOL,
                                           order_equals=crun["order"] == run["order"],
                                           outs_agreement=agreement(run["outs"], crun["outs"])),
                         paged_group=lm.cfg.n_heads // lm.cfg.n_kv_heads, hd=lm.cfg.hd)
        else:
            assert not any(mine.values()), mine
        if lm.cfg.input_mode == "encdec":
            toks = eng._pad_ids([eng.tok.encode(p) for p in PASSAGES[:4]])
            with torch.inference_mode():
                _, caches = eng._prefill(eng._make_batch(toks))
            kvc, xk, xv = caches[0]
            extra = dict(ring_cache_shape=list(kvc.k.shape), cross_k_shape=list(xk.shape),
                         cross_v_shape=list(xv.shape), enc_len=toks.shape[1])
            del caches
        cfg = lm.cfg
        say("archs.model", card=card, arch=cfg.name, dtype=cfg.dtype, input_mode=cfg.input_mode,
            layers=cfg.decoder_layers(), encoder_layers=cfg.encoder_layers(),
            params=sum(p.numel() for p in lm.parameters()), init_seconds=init_s,
            **{k: v for k, v in run.items() if k not in ("ledger", "outs")}, launches=mine,
            prefill_decode_vs_forward_rel_err=prefill_decode_rel_err(lm, seed), **extra,
            wall_seconds=time.perf_counter() - t0,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        if arch == "phi4-mini-3.8b":
            phi4_qchunk(lm, eng, card)
        del eng, lm
        release()
    return dict(launches)


# --------------------------------------------------------- training (train)
TRAIN_ARCH = "minicpm-2b"
TRAIN = dict(batch=4, seq=512, steps=4)
# the crash drill: full width, 2 of 40 layers (the whole state would be 27 GB
# of checkpoint at every save), 4 steps, a checkpoint every 2, a crash after 3
DRILL = dict(depth=2, steps=4, ckpt_every=2, crash_after=3)
# the training example's query (examples/train_ranker_lm.py:55-63)
SERVE_ITEMS = [f"item {i}" for i in range(10)]
SERVE_QUERY = dict(criteria="numeric size", path="ext_pointwise", descending=True, limit=5)
AUTO_SAMPLE = 8


def train_config(steps, **kw) -> TrainConfig:
    """examples/train_ranker_lm.py's settings (two microbatches, int8
    error-feedback gradients, the WSD schedule and its warmup) but for the
    peak rate: the example's 5e-3 suits its reduced model; at full width on
    an H100 it took the loss from 11.7 to 115 in four steps, so the
    optimizer's default 3e-4."""
    return TrainConfig(steps=steps, log_every=0, grad_accum=2, compression=True,
                       optim=OptimConfig(lr=3e-4, schedule="wsd",
                                         warmup_steps=max(steps // 20, 5), total_steps=steps),
                       **kw)


def train_pipe(cfg, seed) -> DataPipeline:
    return DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
                                   global_batch=TRAIN["batch"], seed=seed))


def seeded_lm(cfg, device, seed) -> LM:
    return LM(cfg, device=device, generator=torch.Generator(device).manual_seed(seed))


def release() -> None:
    """Hand the memory of what the caller just deleted back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def state_gb(state) -> float:
    return sum(t.numel() * t.element_size() for t in leaves(state)) / 1e9


def train_full(device, card, seed) -> LM:
    """minicpm-2b, all 40 layers, a few steps through ``Trainer``."""
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = seeded_lm(cfg, device, seed)
    trainer = Trainer(lm, train_config(TRAIN["steps"]))
    state = trainer.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # every leaf as it was, to count the entries the steps moved (5.4 GB; a
    # bf16 entry whose update is under half its last bit does not move)
    before = {path: leaf.detach().clone() for path, leaf in flatten_with_path(state["params"])}
    tokens = TRAIN["batch"] * TRAIN["seq"]
    say("train.model", card=card, arch=cfg.name, layers=cfg.decoder_layers(), d_model=cfg.d_model,
        n_heads=cfg.n_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size, dtype=cfg.dtype,
        params=sum(p.numel() for p in lm.parameters()), state_gb=state_gb(state),
        init_seconds=init_s, batch=TRAIN["batch"], seq=TRAIN["seq"], grad_accum=2,
        compression=True, schedule="wsd", remat=cfg.remat,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

    def on_step(step, rec):
        say("train.step", step=step, loss=rec["loss"], lr=rec["lr"], grad_norm=rec["grad_norm"],
            step_seconds=rec["dt"], tokens_per_s=tokens / rec["dt"],
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

    hist = trainer.run(state, iter(train_pipe(cfg, seed)), resume=False,
                       on_step=on_step)["history"]
    assert len(hist) == TRAIN["steps"]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in hist), hist
    moved = {path_str(path): float((before[path] != leaf.detach()).float().mean())
             for path, leaf in flatten_with_path(state["params"])}
    # LM.loss skips final_norm, as the reference's does: it gets no gradient
    assert moved.pop("final_norm") == 0.0, "final_norm moved without a gradient"
    assert all(v > 0 for v in moved.values()), moved
    say("train.full", steps=len(hist), losses=[r["loss"] for r in hist],
        grad_norms=[r["grad_norm"] for r in hist],
        median_step_seconds=statistics.median(r["dt"] for r in hist[1:]),
        tokens_per_step=tokens, share_of_entries_moved=moved,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del trainer, state, before
    release()
    return lm


def crash_drill(device, seed) -> None:
    """Full width, the depth cut to 2 layers: an uninterrupted run against
    one that crashes after step 3 (its checkpoint is step 2's) and resumes
    in a fresh ``Trainer`` over a freshly drawn model.  The resumed
    parameters must equal the uninterrupted run's bit for bit (the contract
    of the reference's tests/test_fault_tolerance.py:32)."""
    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=DRILL["depth"], pattern=(("attn", DRILL["depth"]),))
    steps = DRILL["steps"]
    lm = seeded_lm(cfg, device, seed)
    tr = Trainer(lm, train_config(steps))
    ref = tr.run(tr.init_state(), iter(train_pipe(cfg, seed)), resume=False)["history"]
    want = [p.detach().cpu() for p in leaves(lm.param_tree())]
    del tr, lm
    release()

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        kw = dict(ckpt_dir=ckpt_dir, ckpt_every=DRILL["ckpt_every"], ckpt_async=False)
        lm = seeded_lm(cfg, device, seed)
        tr = Trainer(lm, train_config(steps, **kw))
        tr.injector.crash_at_step = DRILL["crash_after"]
        t0 = time.perf_counter()
        try:
            tr.run(tr.init_state(), iter(train_pipe(cfg, seed)), resume=False)
            raise AssertionError("the injected failure did not fire")
        except SimulatedFailure:
            crashed_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(ckpt_dir) for f in fs)
        del tr, lm
        release()
        lm = seeded_lm(cfg, device, seed)            # a fresh process would draw anew
        tr = Trainer(lm, train_config(steps, **kw))
        t0 = time.perf_counter()
        out = tr.run(tr.init_state(), iter(train_pipe(cfg, seed)), resume=True)["history"]
        resumed_s = time.perf_counter() - t0
        got = [p.detach().cpu() for p in leaves(lm.param_tree())]
        del tr, lm
        release()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert [r["step"] for r in out] == [3, 4], out
    same_loss = [r["loss"] == ref[r["step"] - 1]["loss"] for r in out]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    assert bitwise and all(same_loss), (same_loss, bitwise)
    say("train.resume_drill", depth_cut=f"{DRILL['depth']} of {full.n_layers} layers",
        width=f"d_model {cfg.d_model}, vocab {cfg.vocab_size}", steps=steps,
        ckpt_every=DRILL["ckpt_every"], crashed_after_step=DRILL["crash_after"],
        resumed_from_step=2, resumed_steps=[r["step"] for r in out],
        losses_equal_uninterrupted=True, params_bitwise_equal=True, leaves=len(got),
        checkpoint_gb=ckpt_bytes / 1e9, crashed_run_seconds=crashed_s,
        resumed_run_seconds=resumed_s)


def record_scores(captured: list):
    """Keep the (keys, folded scores) the pointwise path sorts by (``del
    pointwise_mod._stable_sort_by`` restores the module's own)."""
    inner = pointwise_mod._stable_sort_by

    def counted(keys, values):
        captured.append((list(keys), list(values)))
        return inner(keys, values)

    pointwise_mod._stable_sort_by = counted
    return inner


def record_ballots(captured: list):
    """Keep the ballots and universe of every Borda consensus the optimizer
    takes, and the gold ranking it returned."""
    inner = optimizer_mod.borda_consensus

    def counted(ballots, universe):
        gold = inner(ballots, universe)
        captured.append(([list(b) for b in ballots], list(universe), list(gold)))
        return gold

    optimizer_mod.borda_consensus = counted
    return inner


def serve_trained(lm, device, card) -> tuple:
    """The trained weights through ServeEngine -> ModelOracle ->
    llm_order_by: the example's query, then the budget-aware optimizer with
    Borda selection.  Returns what the two kernels take: the pointwise
    scores with the path's top K, and the ballots with the gold ranking."""
    eng = ServeEngine(lm, paged_kernel=True, max_new_tokens=8, device=lm.device)
    keys = as_keys(SERVE_ITEMS, list(range(len(SERVE_ITEMS))))

    scores = []
    inner = record_scores(scores)
    t0 = time.perf_counter()
    res, _ = llm_order_by(keys, SERVE_QUERY["criteria"], ModelOracle(eng),
                          path=SERVE_QUERY["path"], descending=SERVE_QUERY["descending"],
                          limit=SERVE_QUERY["limit"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pointwise_mod._stable_sort_by = inner
    assert len(res.order) == SERVE_QUERY["limit"] and len(set(res.uids())) == SERVE_QUERY["limit"]
    assert len(scores) == 1, len(scores)
    say("train.serve.query", **SERVE_QUERY, order=res.uids(), n_calls=res.n_calls,
        cost=res.cost, wall_seconds=wall)

    # the budget-aware optimizer with Borda selection; a membership gate
    # that recognised every sampled key would skip the pilots and so the
    # Borda step, and fails the phase
    ballots = []
    inner = record_ballots(ballots)
    t0 = time.perf_counter()
    res2, rep = llm_order_by(keys, SERVE_QUERY["criteria"], ModelOracle(eng), descending=True,
                             path="auto", strategy="borda", sample_size=AUTO_SAMPLE)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    optimizer_mod.borda_consensus = inner
    assert rep.reason == "borda" and len(ballots) == 1, (rep.reason, rep.membership_rate,
                                                         len(ballots))
    assert sorted(res2.uids()) == list(range(len(SERVE_ITEMS))), res2.uids()
    say("train.serve.auto", path="auto", strategy="borda", sample_size=AUTO_SAMPLE,
        membership_rate=rep.membership_rate, chosen=rep.chosen.label,
        reason=rep.reason, sample_scores=rep.sample_scores, order=res2.uids(),
        n_calls=res2.n_calls, cost=res2.cost, wall_seconds=wall2, ballots=len(ballots[0][0]))
    eng.clear_prefix_cache()
    assert eng.pool.blocks_in_use == 0, eng.pool.blocks_in_use
    say("train.serve", card=card, arch=lm.cfg.name, layers=lm.cfg.decoder_layers(),
        stats=dict(vars(eng.stats)), peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return (keys, scores[0], res), ballots[0]


def train_kernels(device, pointwise, borda) -> tuple:
    """``ops.topk_scores`` on the pointwise query's scores and
    ``ops.borda_count`` on the optimizer's ballots, each against its plain
    version and the path's own result.  The queries sort in Python and take
    the consensus in numpy, so these ``kernels.ops`` calls on what they
    captured are the launches counted (as ``train.ops``): the counts are set
    to 0 just before and read just after."""
    keys, (sorted_keys, folded), res = pointwise
    assert [k.uid for k in sorted_keys] == [k.uid for k in keys]
    k = SERVE_QUERY["limit"]
    # the path sorts ascending by -score (descending): undo the fold
    scores = torch.tensor([-v for v in folded], dtype=torch.float32, device=device)
    ballots_uids, universe, gold = borda
    col = {u: i for i, u in enumerate(universe)}
    assert len({len(b) for b in ballots_uids}) == 1, "ballots of unequal length"
    ballots = torch.tensor([[col[u] for u in b] for b in ballots_uids], dtype=torch.int32,
                           device=device)

    reset_launches()                           # ---- the path starts here
    vals, idx = ops.topk_scores(scores, k)
    points = ops.borda_count(ballots, len(universe))
    torch.cuda.synchronize()
    launches = read_launches()                 # ---- and ends here
    assert launches["topk_scores"] > 0 and launches["borda_count"] > 0, launches

    p_vals, p_idx = tk.topk_scores_plain(scores, k)
    assert torch.equal(vals, p_vals) and torch.equal(idx, p_idx), "topk: differs from plain"
    want_vals = torch.sort(scores, descending=True, stable=True).values[:k]
    assert torch.equal(vals, want_vals), "topk: values differ from the path's"
    path_idx = [kk.uid for kk in res.order]
    fifth_tied = bool((scores == vals[-1]).sum() > (vals == vals[-1]).sum())
    if not fifth_tied:
        assert idx.tolist() == path_idx, (idx.tolist(), path_idx)
    assert torch.equal(points, bc.borda_count_plain(ballots, len(universe))), "borda: vs plain"
    want_pts = borda_matrix(ballots.cpu().numpy(), len(universe))
    assert points.cpu().numpy().tolist() == want_pts.tolist(), "borda: vs borda_matrix"
    pts = points.tolist()
    ranked = [universe[i] for i in sorted(range(len(universe)), key=lambda i: (-pts[i], universe[i]))]
    assert ranked == gold, (ranked, gold)
    say("train.kernels", launches={n: launches[n] for n in ("topk_scores", "borda_count")},
        topk=dict(n=int(scores.shape[0]), k=k, values=vals.tolist(), indices=idx.tolist(),
                  path_top_k=path_idx, indices_equal_path=idx.tolist() == path_idx,
                  fifth_value_tied=fifth_tied),
        borda=dict(ballots=list(ballots.shape), points=pts, gold=gold,
                   order_equals_gold=True, points_equal_borda_matrix=True))
    path = {"topk_scores": dict(scores=scores, k=k,
                                tag=f"{TRAIN_ARCH} pointwise scores of {len(keys)} keys"),
            "borda_count": dict(ballots=ballots, n_items=len(universe),
                                tag=f"{TRAIN_ARCH} optimizer ballots over {len(universe)} keys")}
    return launches, path


def phase_train(device, card, seed) -> tuple:
    """Train minicpm-2b whole, drill a crash and resume at depth 2, serve the
    trained weights, and run topk_scores and borda_count on what serving
    produced.  Returns those kernels' launches and their tensors."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = train_full(device, card, seed)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    crash_drill(device, seed)
    t_drill = time.perf_counter() - t0
    t0 = time.perf_counter()
    pointwise, borda = serve_trained(lm, device, card)
    t_serve = time.perf_counter() - t0
    del lm
    release()
    launches, path = train_kernels(device, pointwise, borda)
    say("train.done", train_seconds=t_train, drill_seconds=t_drill, serve_seconds=t_serve)
    return launches, path


# ------------------------------------------------------- serving path (PR 11)
CRITERIA = "relevance to a question about the history of paged memory in operating systems"
ITEMS = [f"passage {i}: " + "the quick brown fox jumps over the lazy dog " * (1 + i % 3)
         for i in range(24)]
STORY = "Summarize the following ticket for the on-call engineer.\nTicket: "
GEN_PROMPTS = (
    [(STORY, f"disk {i} on rack {i * 7} reports {i + 3} reallocated sectors") for i in range(5)]
    + ["hi", "a mid-sized prompt here", "x" * 30 + " long tail", "another one",
       "Write one line about block tables.", "Count to ten.", "q" * 100])
GEN_LIMITS = [32, 24, 16, 32, 8, 4, 32, 12, 32, 20, 28, 32]


def count_steps(engine):
    """Count the decode steps an engine takes (one model pass per step and
    implementation) without touching the kernel's own launch counter and
    without synchronising.  ``del engine._decode_paged`` removes the shim."""
    counts = {"kernel": 0, "dense": 0}
    inner = engine._decode_paged

    def counted(*a, impl):
        counts[impl] += 1
        return inner(*a, impl=impl)

    engine._decode_paged = counted
    return counts


def agreement(a, b) -> float:
    return sum(x == y for x, y in zip(a, b)) / max(len(a), 1)


def drive(lm, card, *, max_new, pool_blocks, assert_tokens: bool, tag: str) -> dict:
    """The serving path on ``lm``: a "check" engine, then the kernel engine
    (probe rounds with shared prefixes, a continuous-batching generate), then
    the dense engine and solo lockstep runs the outputs are held against.
    Returns the kernels' launch counts over the kernel engine's work."""
    cfg = lm.cfg
    n_layers = cfg.decoder_layers()
    kw = dict(max_new_tokens=max_new, pool_blocks=pool_blocks, block_size=16,
              max_decode_rows=32)

    # "check": kernel and dense step side by side, tolerance asserted inline
    check = ServeEngine(lm, paged_kernel="check", **kw)
    steps = count_steps(check)
    outs_check = check.generate(GEN_PROMPTS[:6], max_new_per=[6] * 6)
    torch.cuda.synchronize()
    assert steps["kernel"] == steps["dense"] > 0, steps
    check.clear_prefix_cache()
    assert check.pool.blocks_in_use == 0
    say(f"{tag}.check", steps=steps["kernel"], rtol=PAGED_KERNEL_RTOL, atol=PAGED_KERNEL_ATOL,
        passed=True)
    del check

    eng = ServeEngine(lm, paged_kernel=True, **kw)
    steps = count_steps(eng)
    reset_launches()                           # ---- the path starts here
    pairs = [(it, ITEMS[0]) for it in ITEMS[1:]]
    t0 = time.perf_counter()
    verdicts = eng.compare_many(pairs, CRITERIA)
    scores = eng.score(ITEMS, CRITERIA)
    rescored = eng.score(ITEMS, CRITERIA)      # same regions again: cache hits
    torch.cuda.synchronize()
    t_probe = time.perf_counter() - t0
    probe_rows = eng.stats.probe_rows
    assert len(verdicts) == len(pairs) and all(v in (1, -1) for v in verdicts)
    assert len(scores) == len(ITEMS) and np.isfinite(scores).all()
    assert rescored == scores, "a cached prefix region changed a probe's logits"
    outs = eng.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS)
    torch.cuda.synchronize()
    launches = read_launches()                 # ---- and ends here
    n_steps = steps["kernel"]
    assert launches["paged_attention"] == n_steps * n_layers > 0, (launches, steps)
    assert steps["dense"] == 0
    del eng._decode_paged                      # the rates below run unshimmed

    # the same rounds once more, now warm (libraries initialised, prefix
    # regions resident), for the smoke run's rates
    t0 = time.perf_counter()
    repeat_same = eng.compare_many(pairs, CRITERIA) == verdicts
    repeat_same &= eng.score(ITEMS, CRITERIA) == scores
    torch.cuda.synchronize()
    t_probe_warm = time.perf_counter() - t0
    probe_rows_warm = eng.stats.probe_rows - probe_rows
    before, row_steps = eng.stats.decode_tokens, eng.stats.decode_row_steps
    t0 = time.perf_counter()
    repeat_same &= eng.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS) == outs
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    decode_tokens = eng.stats.decode_tokens - before
    warm_steps = (pa.paged_attention.launches - launches["paged_attention"]) // n_layers
    rows_per_step = (eng.stats.decode_row_steps - row_steps) / warm_steps
    assert eng.stats.prefix_hits > 0, eng.stats
    assert len(outs) == len(GEN_PROMPTS) and all(isinstance(o, str) for o in outs)

    # batched probes against one-at-a-time submissions
    prompts = [eng.score_parts(t, CRITERIA) for t in ITEMS[:6]]
    batched = eng.submit_probes(prompts)
    single = np.concatenate([eng.submit_probes([p]) for p in prompts])
    assert np.isfinite(batched).all() and batched.shape == (6, cfg.vocab_size)
    probe_err = float(np.abs(batched - single).max())
    tol = 1e-4 if cfg.dtype == "float32" else PAGED_KERNEL_ATOL
    assert probe_err <= tol, (probe_err, tol)
    eng.clear_prefix_cache()
    assert eng.pool.blocks_in_use == 0, eng.pool.blocks_in_use
    stats = eng.stats
    del eng

    dense = ServeEngine(lm, paged_kernel=False, **kw)
    outs_dense = dense.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS)
    solo_runs = [dense.generate_lockstep([p], max_new_per=[n])[0]
                 for p, n in zip(GEN_PROMPTS, GEN_LIMITS)]
    assert outs_check == dense.generate(GEN_PROMPTS[:6], max_new_per=[6] * 6)
    del dense
    agree = dict(kernel_vs_dense=agreement(outs, outs_dense),
                 kernel_vs_solo_lockstep=agreement(outs, solo_runs),
                 dense_vs_solo_lockstep=agreement(outs_dense, solo_runs))
    if assert_tokens:
        assert outs == outs_dense, agree
    say(f"{tag}.serve", card=card, arch=cfg.name, dtype=cfg.dtype, layers=n_layers,
        decode_steps=n_steps, kernel_launches=launches,
        launches_per_decode_step=n_layers, decode_tokens=decode_tokens,
        generate_seconds=t_gen, decode_tokens_per_s=decode_tokens / t_gen,
        generate_ms_per_decode_step=1e3 * t_gen / warm_steps,
        decode_rows_per_step=rows_per_step, max_decode_rows=32,
        probe_rows_cold=probe_rows, probe_seconds_cold=t_probe,
        warm_repeat_identical=bool(repeat_same),
        probe_rows=probe_rows_warm, probe_seconds=t_probe_warm,
        probe_rows_per_s=probe_rows_warm / t_probe_warm,
        prefix_hits=stats.prefix_hits, prefix_misses=stats.prefix_misses,
        prefill_tokens=stats.prefill_tokens, probe_batched_vs_single_max_abs=probe_err,
        probe_tolerance=tol, output_agreement=agree,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def phase_main(device, card, seed) -> dict:
    """The first slice's serving path: stablelm-1.6b at full width, bf16,
    seeded random weights."""
    cfg = get_config("stablelm-1.6b")
    t0 = time.perf_counter()
    lm = LM(cfg, device=device, generator=torch.Generator(device).manual_seed(seed))
    torch.cuda.synchronize()
    say("main.model", arch=cfg.name, params=sum(p.numel() for p in lm.parameters()),
        dtype=cfg.dtype, init_seconds=time.perf_counter() - t0)
    return drive(lm, card, max_new=32, pool_blocks=768, assert_tokens=False, tag="main")


def phase_llama(device, card, seed) -> None:
    """llama3-8b reduced (GQA group of 2 in the model code) through the same
    path: bf16 as configured, and fp32 where the kernel engine's tokens must
    equal the dense engine's."""
    import dataclasses
    for dtype, strict in (("bfloat16", False), ("float32", True)):
        cfg = dataclasses.replace(get_reduced("llama3-8b"), dtype=dtype)
        lm = LM(cfg, device=device, generator=torch.Generator(device).manual_seed(seed))
        drive(lm, card, max_new=32, pool_blocks=768, assert_tokens=strict, tag=f"llama.{dtype}")


MESH_PATHS = ("quick", "pointwise")
# full width and depth on the 1x1 mesh: the archs whose stub frontends,
# encoder, SSM and xLSTM blocks take the sharded path since tensor
# parallelism covers every arch
MESH_ARCHS = ("minicpm-2b", "qwen2-vl-7b", "hymba-1.5b", "xlstm-1.3b",
              "seamless-m4t-medium")
MESH_MOE = dict(arch="mixtral-8x7b", depth=4, batch=(2, 32))
EF_LEAF = 1 << 20


def phase_mesh(device, card, seed) -> dict:
    """The distributed slice on one card: a 1x1 ("data", "model") mesh over a
    world-1 NCCL group.  Every check is exact but the MoE loss (the
    reference's 1e-3) and ``ef_allreduce`` (rtol 1e-6)."""
    import torch.distributed as dist
    release()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_local_mesh(1, 1, device=device)
    world, backend = dist.get_world_size(), dist.get_backend()

    def line(tag, t0, **kw):
        torch.cuda.synchronize()
        say(f"mesh.{tag}", card=card, wall_seconds=time.perf_counter() - t0, world_size=world,
            backend=backend, mesh="1x1", peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            **kw)

    cfg = get_config("stablelm-1.6b")
    lm = seeded_lm(cfg, device, seed)            # phase order_by's weights
    keys = as_keys(PASSAGES)
    kw = dict(paged_kernel=False, max_new_tokens=16)
    base = ServeEngine(lm, **kw)
    eng = ServeEngine(lm, mesh=mesh, **kw)
    probes = ([eng.score_parts(p, QUERY) for p in PASSAGES]
              + [eng._compare_parts(a, PASSAGES[0], QUERY) for a in PASSAGES[1:]])
    reset_launches()                           # ---- the mesh path starts here
    t0 = time.perf_counter()
    want = base.submit_probes(probes)
    got = eng.submit_probes(probes)
    assert got.shape == (len(probes), cfg.vocab_size) and np.isfinite(got).all()
    assert np.array_equal(got, want), float(np.abs(got - want).max())
    line("probes", t0, arch=cfg.name, dtype=cfg.dtype, layers=cfg.decoder_layers(),
         rows=len(probes), bitwise=True)
    for path in MESH_PATHS:
        t0 = time.perf_counter()
        qd = dict(path=path, rationale=0)
        bres, _, bledger, _, _ = solo(base, keys, qd)
        sres, _, sledger, delta, _ = solo(eng, keys, qd)
        assert len(sres.order) == 5 and sres.uids() == bres.uids(), (sres.uids(), bres.uids())
        assert sledger == bledger, f"{path}: the sharded engine's ledger differs"
        line("query", t0, path=path, order=sres.uids(), n_calls=sres.n_calls,
             submissions=delta[0], orders_equal=True, ledgers_equal=True)
    t0 = time.perf_counter()
    outs = eng.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS)
    assert outs == base.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS)
    assert_no_leak(eng)
    assert_no_leak(base)
    line("generate", t0, rows=len(GEN_PROMPTS), decode_tokens=eng.stats.decode_tokens,
         tokens_equal=True, leaked_blocks=0)
    t0 = time.perf_counter()
    repl = ServeEngine(lm, mesh=mesh, dp_probe_slices=False, **kw)
    assert np.array_equal(repl.submit_probes(probes), want)
    st, rst = eng.stats, repl.stats
    assert st.dp_sharded_submissions > 0 and rst.dp_sharded_submissions == 0
    assert rst.dp_replicated_submissions > 0
    line("counters", t0, dp_sharded_submissions=st.dp_sharded_submissions,
         dp_replicated_submissions=st.dp_replicated_submissions,
         replicated_engine=dict(dp_sharded_submissions=rst.dp_sharded_submissions,
                                dp_replicated_submissions=rst.dp_replicated_submissions),
         replicated_logits_equal=True)
    t0 = time.perf_counter()
    fsdp = ServeEngine(lm, mesh=mesh, plan=ShardingPlan(fsdp=True), **kw)
    assert np.array_equal(fsdp.submit_probes(probes), want)
    line("fsdp", t0, logits_equal=True)
    mesh_seq_layout(lm, mesh, line, seed)
    launches = read_launches()                 # ---- and ends here
    del base, eng, repl, fsdp, lm
    release()
    for arch in MESH_ARCHS:
        mesh_arch(arch, mesh, device, line, seed)

    t0 = time.perf_counter()
    mcfg = family_config(MESH_MOE["arch"], MESH_MOE["depth"])
    glob = seeded_lm(dataclasses.replace(mcfg, moe_impl="global"), device, seed)
    shard = LM.from_tree(dataclasses.replace(mcfg, moe_impl="sharded"),
                         glob.param_tree()).sharded(mesh)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, mcfg.vocab_size, MESH_MOE["batch"]).astype(np.int32)).to(device)
    with torch.inference_mode():
        loss_g = float(glob.loss({"tokens": toks})[0])
        logits_g = glob.prefill({"tokens": toks})[0]
        with shard_context(mesh, ("data",)):
            loss_s = float(shard.loss({"tokens": toks})[0])
            logits_s = shard.prefill({"tokens": toks})[0]
    diff = float((logits_s.float() - logits_g.float()).abs().max())
    assert math.isfinite(loss_g) and abs(loss_s - loss_g) <= 1e-3, (loss_s, loss_g)
    line("moe_sharded", t0, arch=mcfg.name, layers=mcfg.decoder_layers(), tokens=list(toks.shape),
         loss_global=loss_g, loss_sharded=loss_s, loss_tolerance=1e-3,
         last_logits_max_abs_diff=diff)
    del glob, shard, logits_g, logits_s
    release()

    t0 = time.perf_counter()
    g = torch.randn(EF_LEAF, generator=torch.Generator(device).manual_seed(seed), device=device)
    q, scale, _ = compress_leaf(g, torch.zeros_like(g))
    out = ef_allreduce(mesh, ("data",), q, scale)
    torch.testing.assert_close(out, q.float() * scale, rtol=1e-6, atol=0.0)
    line("ef_allreduce", t0, elements=EF_LEAF, rtol=1e-6,
         max_abs_err=float((out - q.float() * scale).abs().max()))
    del mesh
    dist.destroy_process_group()
    return launches


MESH_SEQ = dict(batch=2, prompt=64, reserve=16, steps=16)


def mesh_seq_layout(lm, mesh, line, seed) -> None:
    """``LM.sharded(mesh, ShardingPlan(cache_layout="seq"))`` given the
    global batch, a prefill and ``MESH_SEQ["steps"]`` decode steps, bitwise
    the unsharded LM's: at one part nothing is cut (every cache a whole
    ``KVCache``)."""
    t0 = time.perf_counter()
    sharded = lm.sharded(mesh, ShardingPlan(cache_layout="seq"))
    b, s = MESH_SEQ["batch"], MESH_SEQ["prompt"]
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, lm.cfg.vocab_size, (b, s + MESH_SEQ["steps"])).astype(np.int32)).to(lm.device)
    with torch.inference_mode():
        want, want_c = lm.prefill({"tokens": toks[:, :s]}, reserve=MESH_SEQ["reserve"])
        with shard_context(mesh, ("data",)):
            got, got_c = sharded.prefill({"tokens": toks[:, :s]}, reserve=MESH_SEQ["reserve"],
                                      global_batch=b)
        assert all(type(c).__name__ == "KVCache" for c in got_c), [type(c) for c in got_c]
        assert torch.equal(got, want)
        for i in range(MESH_SEQ["steps"]):
            tok = toks[:, s + i:s + i + 1]
            want, want_c = lm.decode_step(want_c, tok, s + i)
            with shard_context(mesh, ("data",)):
                got, got_c = sharded.decode_step(got_c, tok, s + i)
            assert torch.equal(got, want), i
        assert all(torch.equal(a, c) for a, c in zip(leaves(got_c), leaves(want_c)))
    line("seq_layout", t0, arch=lm.cfg.name, dtype=lm.cfg.dtype, layers=lm.cfg.decoder_layers(),
         cache_layout="seq", batch=b, prompt=s, reserve=MESH_SEQ["reserve"],
         decode_steps=MESH_SEQ["steps"], caches_cut=False, logits_bitwise=True,
         caches_bitwise=True)
    del sharded


def mesh_arch(arch, mesh, device, line, seed) -> None:
    """``arch`` at full width and depth in bf16 from ``seed``: the 1x1
    sharded engine against the unsharded one, bitwise: probe logits (the
    stub frontends' lookups and the encoder under the shard context), a
    ``quick`` order and ledger, a ``generate``."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = seeded_lm(get_config(arch), device, seed)
    kw = dict(paged_kernel=False, max_new_tokens=16)
    base, eng = ServeEngine(lm, **kw), ServeEngine(lm, mesh=mesh, **kw)
    probes = ([eng.score_parts(p, QUERY) for p in PASSAGES[:6]]
              + [eng._compare_parts(a, PASSAGES[0], QUERY) for a in PASSAGES[1:6]])
    want = base.submit_probes(probes)
    got = eng.submit_probes(probes)
    assert got.shape == (len(probes), lm.cfg.vocab_size) and np.isfinite(got).all()
    assert np.array_equal(got, want), float(np.abs(got - want).max())
    qd = dict(path="quick", rationale=0)
    keys = as_keys(PASSAGES[:6])
    bres, _, bledger, _, _ = solo(base, keys, qd)
    sres, _, sledger, delta, _ = solo(eng, keys, qd)
    assert sres.uids() == bres.uids() and sledger == bledger, (sres.uids(), bres.uids())
    outs = eng.generate(GEN_PROMPTS[:4], max_new_per=GEN_LIMITS[:4])
    assert outs == base.generate(GEN_PROMPTS[:4], max_new_per=GEN_LIMITS[:4])
    cfg = lm.cfg
    line("arch", t0, arch=cfg.name, dtype=cfg.dtype, input_mode=cfg.input_mode,
         kinds=sorted({k for k, _ in cfg.pattern + cfg.enc_pattern}),
         layers=cfg.decoder_layers(), encoder_layers=cfg.encoder_layers(),
         params=sum(p.numel() for p in lm.parameters()), rows=len(probes),
         logits_bitwise=True, order=sres.uids(), n_calls=sres.n_calls, submissions=delta[0],
         ledgers_equal=True, generate_rows=len(outs), tokens_equal=True,
         paged=eng.paged_enabled)
    del base, eng, lm
    release()


# ----------------------------------------------------------- launch tooling
LAUNCH_ARCH = "stablelm-1.6b"
# card-sized cells for the roofline against the card (not in SHAPES: the
# production cells' batches are whole meshes')
CARD_SHAPES = (InputShape("card_decode", 4096, 32, "decode"),
               InputShape("card_prefill", 4096, 4, "prefill"),
               InputShape("card_train", 512, 4, "train"))
CARD_STEPS = 5
# the repo holds no H100 price with a source: an assumed on-demand figure,
# printed as such beside the price sheet it gives
ASSUMED_USD_PER_CARD_HOUR = 2.99
# minicpm-2b at full width, its depth cut from 40 to 2 layers so that two
# trainers (and their checkpoints) fit in turn within the phase's time
SHARDED_TRAIN = dict(arch="minicpm-2b", depth=2, batch=4, seq=256, steps=2)
SHARDED_PLANS = (("zero1", ShardingPlan(), 1, False),
                 ("fsdp", ShardingPlan(fsdp=True), 1, False),
                 ("zero1_accum2_int8", ShardingPlan(), 2, True))
LAUNCH_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
# the applicable cells of the grid (44 less the 7 pure-attention long_500k
# skips), and the archs whose cells tensor parallelism took last
LAUNCH_CELLS = 37
TP_NEW_ARCHS = ("minicpm-2b", "qwen2-vl-7b", "hymba-1.5b", "xlstm-1.3b",
                "seamless-m4t-medium")


def kv_leaf_ids(caches) -> set:
    """The ids of a cache tree's K / V tensors: a KV cache's ``k`` and ``v``
    (whole or a ``KVCacheSlice``) and ``xdec``'s cross pair."""
    out = set()
    for stack in caches:
        for part in (stack if type(stack) is tuple else (stack,)):
            if hasattr(part, "_fields") and "k" in part._fields:
                out |= {id(part.k), id(part.v)}
            elif isinstance(part, torch.Tensor) and part.dim() == 5:
                out.add(id(part))
    return out


def reference_cache_bytes(arch, shape_name, plan=ShardingPlan(), multi_pod=False,
                          kv_only=False) -> int:
    """Per-card bytes of ``arch``'s decode caches at ``shape_name`` in the
    reference's layout on the production mesh: its ``cache_specs`` under
    ``plan`` (feature layout: kv heads over ``model`` where they divide,
    else head_dim; the sequence over the data axes where the batch does not
    divide them; ``seq``: the sequence over ``model``); with ``kv_only``,
    of the K / V leaves alone."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    caches = cache_specs_for(get_config(arch), SHAPES[shape_name])
    specs = cache_specs(caches, mesh, plan)
    kv = kv_leaf_ids(caches)
    return sum(math.prod(local_shape(t.shape, sp, mesh)) * t.element_size()
               for t, sp in zip(leaves(caches), leaves(specs))
               if not kv_only or id(t) in kv)


def port_kv_bytes(arch, shape_name, plan, multi_pod=False, cut=True) -> int:
    """Per-card bytes of the K / V leaves of the caches the port's sharded
    model holds in a decode cell (``launch.specs.cache_specs_for``, as
    ``dryrun_cell`` builds them), or without the cut: the layout before
    context-parallel caches."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    cmesh = CountingMesh(make_production_mesh(multi_pod=multi_pod))
    local = LM(cfg, device="meta").sharded(cmesh, plan)
    d = math.prod(cmesh.shape[a] for a in cmesh.axis_names if a != "model")
    rows = shape.global_batch // d if shape.global_batch % d == 0 else shape.global_batch
    if cut:
        caches = cache_specs_for(cfg, shape, local, rows)
    else:
        cache_len = shape.seq_len // 2 if cfg.input_mode == "encdec" else shape.seq_len
        caches = local.init_caches(rows, cache_len, enc_len=cache_len
                                   if cfg.input_mode == "encdec" else 0)
    kv = kv_leaf_ids(caches)
    return sum(t.numel() * t.element_size() for t in leaves(caches)
               if isinstance(t, torch.Tensor) and id(t) in kv)


def cache_layout_line(r, plan, multi_pod=False) -> dict:
    """The ``launch.cache_layout`` line of a decode cell's record ``r``
    counted under ``plan``: its cache bytes a card beside the reference's
    layout's, whole and K / V alone, the K / V bytes before the cut, the
    all-reduce bytes and the bound."""
    arch, shape = r["arch"], r["shape"]
    line = dict(arch=arch, shape=shape, mesh=r["mesh"], layout=plan.cache_layout,
                cache_bytes=r["memory_analysis"]["cache_size_in_bytes"],
                reference_layout_cache_bytes=reference_cache_bytes(arch, shape, plan, multi_pod),
                kv_bytes=port_kv_bytes(arch, shape, plan, multi_pod),
                reference_layout_kv_bytes=reference_cache_bytes(arch, shape, plan, multi_pod,
                                                                kv_only=True),
                kv_bytes_uncut=port_kv_bytes(arch, shape, plan, multi_pod, cut=False),
                all_reduce_bytes=r["collectives"]["bytes"]["all-reduce"],
                all_reduce_count=r["collectives"]["counts"]["all-reduce"],
                step_time_bound_s=r["roofline"]["step_time_bound_s"])
    say("launch.cache_layout", **line)
    return line


def head_spans(cfg, model: int) -> dict:
    """What a cut of ``n_heads * hd`` over ``model`` processes costs: the q
    heads a card attends (the whole heads its rows of ``wo`` read) against
    ``n_heads / model``, and the kv heads it caches."""
    rows = cut_rows(cfg.n_heads * cfg.hd, model)
    kv = cfg.n_kv_heads if cfg.pattern[0][0] not in ("mlstm", "slstm") else cfg.n_heads
    spans = [head_span(cfg.n_heads, kv, cfg.hd, rows, r) for r in range(model)]
    return dict(model=model, n_heads=cfg.n_heads, kv_heads=kv, hd=cfg.hd,
                q_heads_per_card=[sp.nq for sp in spans],
                kv_heads_per_card=[sp.nkv for sp in spans],
                attention_flops_ratio=sum(sp.nq for sp in spans) / cfg.n_heads)


def launch_grid(card) -> list:
    """``dryrun_cell`` over every arch x shape on the single-pod production
    mesh and llama3-8b's shapes on the multi-pod one.  No cell may fail:
    every applicable cell must carry memory, FLOP, byte, collective and
    roofline entries.  Each cell of the archs whose cut falls inside a head
    or that tensor parallelism took last (``TP_NEW_ARCHS``) prints its
    per-card argument, temp and cache bytes and its bound on a line of its
    own."""
    os.makedirs(LAUNCH_OUT, exist_ok=True)
    out = os.path.join(LAUNCH_OUT, "launch_dryrun.jsonl")
    if os.path.exists(out):
        os.remove(out)
    t0 = time.perf_counter()
    recs, _ = dryrun_mod.dryrun_records(list_archs(), list(SHAPES), [False], out=out,
                                        verbose=False)
    multi, _ = dryrun_mod.dryrun_records(["llama3-8b"], list(SHAPES), [True], out=out,
                                         verbose=False)
    wall = time.perf_counter() - t0
    recs += multi
    model_axis = make_production_mesh().shape["model"]
    errors = [(r["arch"], r["shape"], r["error"]) for r in recs if "error" in r]
    assert not errors, errors
    applicable = [r for r in recs if cell_applicable(get_config(r["arch"]), r["shape"])[0]]
    counted = [r for r in recs if "skipped" not in r]
    assert len(counted) == len(applicable) == LAUNCH_CELLS, (len(counted), len(applicable))
    for r in counted:
        ma, ca, rf = r["memory_analysis"], r["cost_analysis"], r["roofline"]
        assert min(ma["argument_size_in_bytes"], ma["output_size_in_bytes"],
                   ma["temp_size_in_bytes"]) > 0, r
        assert ca["flops"] > 0 and ca["bytes accessed"] > 0, r
        assert r["collectives"]["total_bytes"] > 0 and rf["step_time_bound_s"] > 0, r
        if r["arch"] in TP_NEW_ARCHS:
            ref_cache = (reference_cache_bytes(r["arch"], r["shape"])
                         if r["kind"] == "decode" else 0)
            say("launch.cell", arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                argument_bytes=ma["argument_size_in_bytes"], temp_bytes=ma["temp_size_in_bytes"],
                cache_bytes=ma["cache_size_in_bytes"], reference_layout_cache_bytes=ref_cache,
                all_gather_bytes=r["collectives"]["bytes"]["all-gather"],
                all_reduce_bytes=r["collectives"]["bytes"]["all-reduce"],
                flops=ca["flops"], inner_scan_correction=rf["inner_scan_correction"],
                dominant=rf["dominant"], step_time_bound_s=rf["step_time_bound_s"])
    for arch in TP_NEW_ARCHS:
        say("launch.heads", arch=arch, **head_spans(get_config(arch), model_axis))
    # context-parallel caches: batch 1 cuts the long_500k caches' sequence
    # over the data axes; under ``seq`` every decode_32k cell cuts it over
    # ``model``.  The K / V bytes a card are the reference layout's, except
    # where the reference cuts head_dim inside a kv head (hymba's 5 heads)
    t_seq = time.perf_counter()
    seq = ShardingPlan(cache_layout="seq")
    seq_recs, _ = dryrun_mod.dryrun_records(list_archs(), ["decode_32k"], [False], out=out,
                                            verbose=False, plan=seq)
    seq_multi, _ = dryrun_mod.dryrun_records(["llama3-8b"], ["decode_32k"], [True], out=out,
                                             verbose=False, plan=seq)
    seq_wall = time.perf_counter() - t_seq
    errors = [(r["arch"], r["shape"], r["error"]) for r in seq_recs + seq_multi if "error" in r]
    assert not errors and len(seq_recs) == len(list_archs()), errors
    for r, plan in [(r, ShardingPlan()) for r in counted if r["shape"] == "long_500k"] \
            + [(r, seq) for r in seq_recs + seq_multi]:
        line = cache_layout_line(r, plan, multi_pod=r["multi_pod"])
        if r["arch"] in ("mixtral-8x7b", "mixtral-8x22b") or plan is seq:
            assert line["kv_bytes"] == line["reference_layout_kv_bytes"], line
        if r["shape"] == "long_500k" and line["kv_bytes"]:
            assert line["kv_bytes_uncut"] == 32 * line["kv_bytes"], line
    print(report_mod.dryrun_table(recs), flush=True)
    print(report_mod.roofline_table(recs), flush=True)
    say("launch.grid", card=card, cells=len(recs), counted=len(counted), errors=len(errors),
        skipped=sum("skipped" in r for r in recs), wall_seconds=wall,
        count_seconds=sum(r.get("count_s", 0.0) for r in counted),
        new_cells=sum(r["arch"] in TP_NEW_ARCHS for r in counted),
        seq_layout_cells=len(seq_recs) + len(seq_multi), seq_layout_wall_seconds=seq_wall,
        records=os.path.relpath(out, os.path.dirname(LAUNCH_OUT)))
    return recs


def card_cell(kind, lm, mesh, shape, device, seed):
    """The arguments of one step of ``kind`` on the card, and the step."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, lm.cfg.vocab_size, (
        shape.global_batch, 1 if kind == "decode" else shape.seq_len)).astype(np.int32)).to(device)
    if kind == "train":
        trainer = Trainer(lm, TrainConfig(log_every=0), mesh=mesh)
        state = trainer.init_state()
        batch = {"tokens": tokens}
        return [state, batch], lambda: trainer.step(state, batch)
    local = lm.sharded(mesh)
    if kind == "prefill":
        batch = {"tokens": tokens}

        def prefill():
            with shard_context(mesh, ()), torch.no_grad():
                return local.prefill(batch)
        return [local.param_tree(), batch], prefill
    caches = local.init_caches(shape.global_batch, shape.seq_len)

    def decode():
        with shard_context(mesh, ()), torch.no_grad():
            return local.decode_step(caches, tokens, shape.seq_len - 1)
    return [local.param_tree(), caches, tokens], decode


def launch_roofline(lm, mesh, device, card, seed) -> list:
    """Each card-sized cell: the dry-run's record at 1x1 against the median
    of ``CARD_STEPS`` real steps (CUDA events).  The step may not beat its
    bound, and the dry-run's argument bytes are the card's."""
    one = AbstractMesh(("data", "model"), (1, 1))
    out = []
    for shape in CARD_SHAPES:
        kind = shape.kind
        rec = dryrun_mod.dryrun_cell(LAUNCH_ARCH, shape.name, mesh=one, shape=shape,
                                     verbose=False)
        args, step = card_cell(kind, lm, mesh, shape, device, seed)
        arg_bytes = dryrun_mod.storage_bytes(leaves(args))
        step()                                        # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(CARD_STEPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            res = step()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
            del res
        step_peak = torch.cuda.max_memory_allocated() - base
        rf, ma = rec["roofline"], rec["memory_analysis"]
        t = statistics.median(times)
        assert t >= rf["step_time_bound_s"], (kind, t, rf)
        assert ma["argument_size_in_bytes"] == arg_bytes, (kind, ma, arg_bytes)
        say("launch.roofline", card=card, arch=LAUNCH_ARCH, kind=kind,
            batch=shape.global_batch, seq=shape.seq_len, bound_s=rf["step_time_bound_s"],
            dominant=rf["dominant"], compute_s=rf["compute_s"], memory_s=rf["memory_s"],
            step_seconds_median=t, step_seconds=times,
            bound_over_time=rf["step_time_bound_s"] / t,
            dryrun_flops=rec["cost_analysis"]["flops"],
            dryrun_bytes=rec["cost_analysis"]["bytes accessed"],
            argument_bytes=arg_bytes, argument_bytes_equal=True,
            dryrun_temp_bytes=ma["temp_size_in_bytes"],
            card_peak_less_resident_bytes=step_peak)
        out.append(rec)
        del args, step
        release()
    return out


def launch_pricing(lm, recs, card) -> dict:
    """The self-hosted price sheet from the grid's stablelm-1.6b prefill_32k
    and decode_32k records, driving a judged ``auto`` query through the
    paged kernel; its report's cost must be the oracle's spend."""
    sheet = pricing_mod.price_sheet_from_records(
        recs, LAUNCH_ARCH, chip_hour_usd=ASSUMED_USD_PER_CARD_HOUR)
    eng = ServeEngine(lm, paged_kernel=True, max_new_tokens=16)
    qd = QUERIES[0]
    oracle = ModelOracle(eng, prices=sheet, judge_rationale_tokens=qd["rationale"])
    reset_launches()                           # ---- the launch path starts here
    t0 = time.perf_counter()
    res, rep = llm_order_by(as_keys(PASSAGES), QUERY, oracle, **query_kw(qd))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                 # ---- and ends here
    spend = oracle.spend()
    assert math.isclose(rep.total_cost, spend, rel_tol=1e-6), (rep.total_cost, spend)
    assert launches["paged_attention"] > 0, launches
    assert len(res.order) == 5 and len(set(res.uids())) == 5, res.uids()
    assert_no_leak(eng)
    say("launch.pricing", card=card, arch=LAUNCH_ARCH, sheet=sheet.name,
        usd_per_card_hour=ASSUMED_USD_PER_CARD_HOUR,
        usd_per_card_hour_is="assumed: the repo holds no H100 price with a source",
        input_per_mtok=sheet.input_per_mtok, output_per_mtok=sheet.output_per_mtok,
        path=qd["path"], chosen=rep.chosen.label, total_cost=rep.total_cost, spend=spend,
        n_calls=res.n_calls, order=res.uids(), wall_seconds=wall, launches=launches,
        leaked_blocks=0)
    del eng
    return launches


def same_files(a, b) -> bool:
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        return False
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def launch_sharded_training(mesh, device, card, seed) -> None:
    """minicpm-2b at full width, 2 layers: the sharded ``Trainer`` on the
    1x1 mesh against the unsharded one, each plan two steps from the same
    seeded weights and batches; losses, gradient norms and every state entry
    bitwise, and the first plan's checkpoint files byte-equal."""
    st = SHARDED_TRAIN
    full = get_config(st["arch"])
    cfg = dataclasses.replace(full, n_layers=st["depth"], pattern=(("attn", st["depth"]),))
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=st["seq"],
                                   global_batch=st["batch"], seed=seed))
    batches = [pipe.batch(i) for i in range(st["steps"])]
    tmp = tempfile.mkdtemp(prefix="launch_ckpt_")
    try:
        for i, (name, plan, accum, int8) in enumerate(SHARDED_PLANS):
            t0 = time.perf_counter()
            runs = []
            for sharded in (False, True):
                ckpt_dir = os.path.join(tmp, f"{name}_{int(sharded)}") if i == 0 else None
                tc = TrainConfig(steps=st["steps"], log_every=0, grad_accum=accum,
                                 compression=int8, ckpt_dir=ckpt_dir, ckpt_async=False,
                                 optim=OptimConfig(lr=3e-4, warmup_steps=1, schedule="const"))
                lm = seeded_lm(cfg, device, seed)
                trainer = (Trainer(lm, tc, mesh=mesh, plan=plan) if sharded
                           else Trainer(lm, tc))
                state = trainer.init_state()
                hist = trainer.run(state, iter(batches), resume=False)["history"]
                runs.append(([(r["loss"], r["grad_norm"]) for r in hist],
                             [t.detach().clone() for t in leaves(state)], ckpt_dir))
                del trainer, state, lm
                release()
            (h0, s0, c0), (h1, s1, c1) = runs
            assert h1 == h0, (name, h0, h1)
            assert len(s0) == len(s1) and all(torch.equal(a, b) for a, b in zip(s0, s1)), name
            files_equal = None
            if c0 is not None:
                files_equal = same_files(os.path.join(c0, f"step_{st['steps']}", "host_0"),
                                         os.path.join(c1, f"step_{st['steps']}", "host_0"))
                assert files_equal, name
            say("launch.sharded_train", card=card, arch=cfg.name, layers=st["depth"],
                layers_of_full=full.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
                plan=name, grad_accum=accum, compression=int8, mesh="1x1",
                backend=torch.distributed.get_backend(), losses=[h[0] for h in h0],
                grad_norms=[h[1] for h in h0], state_entries_bitwise=True,
                checkpoint_files_byte_equal=files_equal,
                wall_seconds=time.perf_counter() - t0)
            del runs, s0, s1
            release()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_launch(device, card, seed) -> dict:
    """The launch-tooling slice on one card: the dry-run grid, the roofline
    of stablelm-1.6b against its real steps on a 1x1 NCCL mesh, the
    self-priced query through the paged kernel, and the sharded trainer."""
    import torch.distributed as dist
    release()
    t0 = time.perf_counter()
    recs = launch_grid(card)
    mesh = make_local_mesh(1, 1, device=device)
    lm = seeded_lm(get_config(LAUNCH_ARCH), device, seed)    # phase order_by's weights
    launches = launch_pricing(lm, recs, card)
    launch_roofline(lm, mesh, device, card, seed)   # its train step moves the weights
    del lm
    release()
    launch_sharded_training(mesh, device, card, seed)
    say("launch.done", card=card, wall_seconds=time.perf_counter() - t0,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del mesh
    dist.destroy_process_group()
    return launches


def phase_analysis() -> None:
    """The port's invariant linter (``repro_torch.analysis``, stdlib only)
    over the port, its tests and this script, on the card's machine, which
    has no JAX: no finding, and no JAX module loaded."""
    from repro_torch.analysis import ALL_RULES, run_paths
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    paths = [p for p in ("src/repro_torch", "tests", "chip_smoke.py")
             if os.path.exists(os.path.join(root, p))]
    report = run_paths(paths, root=Path(root))
    jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    say("analysis", paths=paths, files=report.files, findings=len(report.findings),
        suppressed=report.suppressed, rules=[r.id for r in ALL_RULES], jax_modules=jax_loaded,
        wall_seconds=time.perf_counter() - t0)
    assert report.files > 100 and not report.findings, [str(f) for f in report.findings]
    assert not jax_loaded, jax_loaded


def traced(fn, card, tag, **extra) -> None:
    """Run ``fn`` once untimed (warm-up), then once under torch.profiler;
    report the kernels by device time and their sum."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernels only: an operator's entry repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:12]
    say(tag, card=card, device_busy_ms=busy_ms,
        kernel_launches=sum(e.count for e in events),
        kernels=[dict(name=e.key[:80], calls=e.count, device_ms=dev_us(e) / 1e3) for e in top],
        **extra)


def phase_profile(device, card, seed) -> None:
    """Not part of the default run: trace flash attention and top-k at their
    large timed shapes, decode and paged attention at llama3-8b's timed
    shapes, the bf16 mLSTM scan at xLSTM's width, the SSM scan at Hymba's
    layer 0, MoE gating at Mixtral's 16 x 128 probe batch and 16 x 2048
    prefill, Borda count at the optimizer's ballots (4 of 8 over 8 items),
    one generate of the kernel engine at stablelm-1.6b's full width, then
    one training step of the whole minicpm-2b as phase train runs it."""
    d = FULL["llama3-8b"]
    ctx = np.random.default_rng(7).integers(17, FULL_MAXB * FULL_BS + 1, size=FULL_ROWS)
    pargs = paged_case(11, FULL_ROWS, d["h"], d["kv"], d["hd"], FULL_BS, FULL_NB, FULL_MAXB,
                       torch.bfloat16, device, ctx=ctx)
    traced(lambda: pa.paged_attention(*pargs), card, "profile.paged_attention",
           arch="llama3-8b", dtype="bfloat16", rows=FULL_ROWS)
    margs = mlstm_inputs(69, *FALLBACK_FAMILY["mlstm"], torch.bfloat16, device)
    traced(lambda: ml.mlstm_scan(*margs), card, "profile.mlstm_scan", dtype="bfloat16",
           shape=list(FALLBACK_FAMILY["mlstm"]))
    hb, hs, hd, hn = HYMBA_LAYER0
    sargs = ssm_inputs(59, hb, hs, hd, hn, torch.bfloat16, device)
    traced(lambda: ss.ssm_scan(*sargs, block_d=hd, chunk=hs), card, "profile.ssm_scan",
           dtype="bfloat16", shape=list(HYMBA_LAYER0), plan=ss.ssm_plan(hd, hn)._asdict())
    for t in (hb * hs, GATING_PREFILL["t"]):
        lg = randn(np.random.default_rng(41), (t, 8), torch.float32, device)
        traced(lambda: mg.moe_gating(lg, 2), card, "profile.moe_gating", tokens=t, experts=8,
               k=2, plan=mg.gating_plan(t, 8, 2)._asdict())
    del pargs, margs, sargs, lg
    f = DECODE_FULL
    dargs = decode_inputs(17, f["b"], d["h"], d["kv"], f["s"], d["hd"], f["fill"],
                          torch.bfloat16, device)
    traced(lambda: da.decode_attention(*dargs), card, "profile.decode_attention",
           arch="llama3-8b", dtype="bfloat16")
    ballots = borda_ballots(98, 4, 8, 8, device)
    traced(lambda: bc.borda_count(ballots, 8), card, "profile.borda_count", ballots=[4, 8],
           n_items=8, route=bc.borda_plan(4, 8, 8).route)
    del dargs, ballots
    s = FLASH_MONOLITHIC
    for arch, d in FULL.items():
        q, k, v = flash_inputs(13, s["b"], d["h"], d["kv"], s["sq"], s["sk"], d["hd"],
                               torch.bfloat16, device)
        traced(lambda: fa.flash_attention(q, k, v, causal=True), card,
               "profile.flash_attention", arch=arch, dtype="bfloat16", seq=s["sq"])
    big = randn(np.random.default_rng(81), (TOPK_LARGE["n"],), torch.float32, device)
    traced(lambda: tk.topk_scores(big, TOPK_LARGE["k"]), card, "profile.topk_scores",
           n=TOPK_LARGE["n"], k=TOPK_LARGE["k"])
    del q, k, v, big
    lm = seeded_lm(get_config("stablelm-1.6b"), device, seed)
    eng = ServeEngine(lm, paged_kernel=True, max_new_tokens=32)
    traced(lambda: eng.generate(GEN_PROMPTS, max_new_per=GEN_LIMITS), card, "profile")
    del eng, lm
    release()

    cfg = get_config(TRAIN_ARCH)
    lm = seeded_lm(cfg, device, seed)
    trainer = Trainer(lm, train_config(3))
    state = trainer.init_state()
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in train_pipe(cfg, seed).batch(0).items()}
    traced(lambda: trainer.step(state, batch), card, "profile.train_step", arch=cfg.name,
           tokens=TRAIN["batch"] * TRAIN["seq"], grad_accum=2, compression=True)
    del trainer, state, lm
    release()


# --------------------------------------------------------------------- main
DEFAULT_PHASES = "analysis,order_by,families,archs,train,kernels,ops,main,llama,mesh,launch"
FALLBACK_CONT = [("fixed (phase order_by did not run)", dict(b=32, sq=64, off=192, sk=256))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=DEFAULT_PHASES,
                    help="comma-separated subset of analysis,order_by,families,archs,train,"
                         "kernels,ops,main,llama,mesh,launch,profile")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = card_line()
    say("card", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    wall = _build.build_all()
    say("build", seconds_per_source=_build.build_seconds, wall_seconds=wall,
        nvcc=_build.find_nvcc())

    if "analysis" in phases:
        phase_analysis()
    launches_by_path = {}
    cont_shapes = FALLBACK_CONT
    fam = {}
    train_path = {}
    if "order_by" in phases:
        launches_by_path["order_by"], cont_shapes = phase_order_by(device, card, args.seed)
    if "families" in phases:
        launches_by_path["families"], fam = phase_families(device, card, args.seed)
    if "archs" in phases:
        launches_by_path["archs"] = phase_archs(device, card, args.seed)
    if "train" in phases:
        launches_by_path["train.ops"], train_path = phase_train(device, card, args.seed)
    kernels = (phase_kernels(device, cont_shapes, fam, train_path) if "kernels" in phases
               else None)
    if "ops" in phases:
        launches_by_path["kernels.ops"] = phase_ops(device)
    if "main" in phases:
        launches_by_path["serve"] = phase_main(device, card, args.seed)
    if "llama" in phases:
        phase_llama(device, card, args.seed)
    if "mesh" in phases:
        launches_by_path["mesh"] = phase_mesh(device, card, args.seed)
    if "launch" in phases:
        launches_by_path["launch"] = phase_launch(device, card, args.seed)
    if "profile" in phases:
        phase_profile(device, card, args.seed)
    if kernels is not None and {"order_by", "families", "train", "ops"} <= phases:
        for k in kernels:
            # ``launches``: the count on the path that reaches the kernel
            # (order_by for the paged kernel, the ops path for flash and
            # decode, families for the MoE / SSM / mLSTM kernels), each path
            # counted from 0 just before it ran.  train.ops counts top-k and
            # Borda as ``kernels.ops`` calls on the tensors the train path's
            # queries produced: the queries themselves sort in Python and
            # take the Borda consensus in numpy, as the reference's do
            k["launches_by_path"] = {p: n[k["name"]] for p, n in launches_by_path.items()}
            k["launches"] = k["launches_by_path"][k["path"]]
            assert k["launches"] > 0, f"{k['name']} never launched on {k['path']}"
    elif kernels is not None:
        say("note", text="phases order_by, families, train and ops did not all run: no "
                         "launch counts, so no kernels line")
        kernels = None
    say("done", seconds=time.perf_counter() - t_start)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
