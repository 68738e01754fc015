"""Own copy of ``src/repro/configs/mixtral_8x22b.py``.

mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig, MoESpec


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        pattern=(("moe_swa", 56),),
        moe=MoESpec(n_experts=8, top_k=2, capacity_factor=1.25),
        sliding_window=4096,
        rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        pattern=(("moe_swa", 2),),
        moe=MoESpec(n_experts=4, top_k=2, capacity_factor=4.0),
        sliding_window=16,
        rope_theta=1_000_000.0,
        scan_chunk=8,
    )
