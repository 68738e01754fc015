"""Own copy of ``src/repro/configs/stablelm_1p6b.py``.

stablelm-1.6b [dense] — 24L d_model=2048 32H (GQA kv=32) d_ff=5632
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b; unverified]
Adaptation note: StableLM-2 uses partial-rotary (25%) + biased LayerNorm; we
use full-rotary RMSNorm blocks (shared block library), documented in
DESIGN.md."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab_size=100352,
        pattern=(("attn", 24),),
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=176, vocab_size=512,
        pattern=(("attn", 2),),
        rope_theta=10_000.0,
        scan_chunk=8,
    )
