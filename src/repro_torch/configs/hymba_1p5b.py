"""Own copy of ``src/repro/configs/hymba_1p5b.py``.

hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + Mamba heads in every block.
[arXiv:2411.13676; hf]

Adaptation (DESIGN.md §5): Hymba's 3 global-attention layers + meta tokens
become 4 group-uniform global layers (1 global + 7 sliding-window per group
of 8) so every stack is scan-homogeneous; meta tokens are dropped.  The
long_500k cell runs with a linear-in-4-layers dense cache (global layers)
plus O(1) SSM/ring state everywhere else."""
from repro_torch.models.config import ModelConfig, grouped_pattern


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001,
        pattern=grouped_pattern(4, ("hymba_g", 1), ("hymba_l", 7)),
        ssm_state=16,
        sliding_window=1024,
        rope_theta=10_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        pattern=grouped_pattern(1, ("hymba_g", 1), ("hymba_l", 2)),
        ssm_state=4,
        sliding_window=16,
        rope_theta=10_000.0,
        scan_chunk=8,
    )
