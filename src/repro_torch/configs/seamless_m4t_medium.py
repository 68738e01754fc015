"""Own copy of ``src/repro/configs/seamless_m4t_medium.py``.

seamless-m4t-medium [audio] — 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206 — encoder-decoder, multimodal.  [arXiv:2308.11596; hf]

Per the assignment, only the transformer BACKBONE is modeled: 12 encoder
layers (bidirectional) + 12 decoder layers (self + cross attention).  The
audio frontend is a STUB — ``input_specs()`` supplies precomputed frame
embeddings as the encoder input.  Train/serve shapes split seq_len equally
between encoder and decoder (documented in DESIGN.md)."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=256206,
        pattern=(("xdec", 12),),
        enc_pattern=(("enc", 12),),
        input_mode="encdec",
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512,
        pattern=(("xdec", 2),),
        enc_pattern=(("enc", 2),),
        input_mode="encdec",
        rope_theta=10_000.0,
        scan_chunk=8,
    )
