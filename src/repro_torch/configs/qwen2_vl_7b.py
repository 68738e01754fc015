"""Own copy of ``src/repro/configs/qwen2_vl_7b.py``.

qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE (temporal/height/width sections 16/24/24), dynamic
resolution.  [arXiv:2409.12191; hf]

Vision frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings (B, S, D) plus 3D M-RoPE position ids (3, B, S)."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064,
        pattern=(("attn", 28),),
        mrope_sections=(16, 24, 24),   # sums to head_dim//2 = 64
        input_mode="embeds",
        rope_theta=1_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        pattern=(("attn", 2),),
        mrope_sections=(2, 3, 3),      # sums to head_dim//2 = 8
        input_mode="embeds",
        rope_theta=1_000_000.0,
        scan_chunk=8,
    )
