"""Own copy of ``src/repro/configs/minicpm_2b.py``.

minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 — WSD schedule (wired in training/optimizer.py), MiniCPM
depth-scaled residuals + scaled/tied embeddings.  [arXiv:2404.06395; hf]"""
import math

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab_size=122753,
        pattern=(("attn", 40),),
        rope_theta=10_000.0,
        tie_embeddings=True,
        embed_scale=12.0,
        residual_scale=1.4 / math.sqrt(40),
        logit_scale=256.0 / 2304.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab_size=512,
        pattern=(("attn", 2),),
        rope_theta=10_000.0,
        tie_embeddings=True,
        embed_scale=12.0,
        residual_scale=1.4 / math.sqrt(2),
        logit_scale=256.0 / 2304.0,
        scan_chunk=8,
    )
