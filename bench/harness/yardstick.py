"""The yardstick: the card's peak.

The peak is a copy of ``src/repro_torch/launch/mesh.py`` (commit
59c63ea40a24): NVIDIA's H100 SXM data sheet, the dense bf16 rate at 700 W.
The FLOPs the answered work needs are counted by the configuration's
architecture (``bench/architectures/<name>.py``: ``prompt_flops``).
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12    # FLOP/s, dense bf16 on the tensor cores
