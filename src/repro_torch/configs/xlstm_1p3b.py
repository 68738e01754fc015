"""Own copy of ``src/repro/configs/xlstm_1p3b.py``.

xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks.  [arXiv:2405.04517; unverified]

Layout: 6 groups of (7 mLSTM + 1 sLSTM) — the paper's ~7:1 interleave made
scan-homogeneous.  mLSTM uses matrix memory with v head_dim 512 and q/k
head_dim 256 (the paper's 0.5 qk projection factor); no FFN (d_ff=0), the
gated projections live inside the blocks."""
from repro_torch.models.config import ModelConfig, grouped_pattern


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        pattern=grouped_pattern(6, ("mlstm", 7), ("slstm", 1)),
        head_dim=512, qk_dim=256,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=512,
        pattern=grouped_pattern(1, ("mlstm", 2), ("slstm", 1)),
        head_dim=16, qk_dim=8,
        scan_chunk=8,
    )
