"""Own copy of ``src/repro/configs/mixtral_8x7b.py``.

mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig, MoESpec


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        pattern=(("moe_swa", 32),),
        moe=MoESpec(n_experts=8, top_k=2, capacity_factor=1.25),
        sliding_window=4096,
        rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=112, vocab_size=512,
        pattern=(("moe_swa", 2),),
        moe=MoESpec(n_experts=4, top_k=2, capacity_factor=4.0),
        sliding_window=16,
        rope_theta=1_000_000.0,
        scan_chunk=8,
    )
