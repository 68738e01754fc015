"""Own copy of ``src/repro/configs/llama3_8b.py``.

llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA, 128k vocab, rope theta 500k.  [arXiv:2407.21783]"""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256,
        pattern=(("attn", 32),),
        rope_theta=500_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=224, vocab_size=512,
        pattern=(("attn", 2),),
        rope_theta=500_000.0,
        scan_chunk=8,
    )
