"""Own copy of ``src/repro/configs/phi4_mini_3p8b.py``.

phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab_size=200064,
        pattern=(("attn", 32),),
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        pattern=(("attn", 2),),
        rope_theta=10_000.0,
        scan_chunk=8,
    )
