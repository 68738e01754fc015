"""input_specs(): ``meta``-device stand-ins for every model input of every
(arch x shape) cell: shape and dtype, no storage.

Counterpart of ``src/repro/launch/specs.py``, whose ``jax.ShapeDtypeStruct``
leaves are ``torch.empty(..., device="meta")`` tensors here, and whose
``jax.eval_shape`` of ``LM.init_caches`` is ``init_caches`` of an ``LM``
built on ``meta`` (nothing drawn, nothing allocated).

Cell semantics:
  train_4k     Trainer.step(state, batch)          tokens (B, S)
  prefill_32k  LM.prefill(batch)                   context ingestion
  decode_32k   LM.decode_step(caches, tok, pos)    one token, S-cache
  long_500k    decode_step with a 524288-token state  (sub-quadratic archs)

Modality stubs as in the reference: [vlm] gets precomputed patch embeddings
(B, S, D) + M-RoPE position ids (3, B, S); [audio] gets encoder frame
embeddings; enc-dec splits seq_len equally between encoder and decoder.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..models.config import SHAPES, InputShape, ModelConfig
from ..models.model import LM

i32 = torch.int32
bf16 = torch.bfloat16


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs_for(cfg: ModelConfig, shape: InputShape) -> dict[str, Any]:
    """Abstract batch for train/prefill cells."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeds":
        out = {"embeds": sds((b, s, cfg.d_model), bf16)}
        if cfg.mrope_sections:
            out["positions"] = sds((3, b, s), i32)
        if shape.kind == "train":
            out["tokens"] = sds((b, s), i32)     # targets
        return out
    if cfg.input_mode == "encdec":
        se = s // 2
        return {"enc_embeds": sds((b, se, cfg.d_model), bf16),
                "tokens": sds((b, se), i32)}
    return {"tokens": sds((b, s), i32)}


def cache_specs_for(cfg: ModelConfig, shape: InputShape, lm: Optional[LM] = None,
                    batch: Optional[int] = None) -> Any:
    """Abstract decode caches (a list of layer-stacked caches, one a stack)
    for decode cells: the whole model's, or with ``lm`` (a sharded LM on
    ``meta``) its process's part of ``batch`` rows."""
    lm = lm or LM(cfg, device="meta")
    b = batch or shape.global_batch
    cache_len = shape.seq_len if cfg.input_mode != "encdec" else shape.seq_len // 2
    enc_len = shape.seq_len // 2 if cfg.input_mode == "encdec" else 0
    return lm.init_caches(b, cache_len, enc_len=enc_len)


def decode_token_spec(cfg: ModelConfig, shape: InputShape) -> Any:
    b = shape.global_batch
    if cfg.input_mode == "embeds":
        return sds((b, 1, cfg.d_model), bf16)
    return sds((b, 1), i32)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict[str, Any]:
    """All abstract inputs for one cell (params excluded — see dryrun)."""
    shape = SHAPES[shape_name]
    out: dict[str, Any] = {"batch": batch_specs_for(cfg, shape)}
    if shape.kind == "decode":
        out = {
            "caches": cache_specs_for(cfg, shape),
            "token": decode_token_spec(cfg, shape),
            "position": sds((), i32),
        }
    return out


def cell_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic-state archs (DESIGN.md skip table)."""
    if shape_name == "long_500k" and not cfg.long_context_ok:
        return False, ("pure full-attention arch: a 524288-token dense KV "
                       "cache is not sub-quadratic (documented skip)")
    return True, ""
