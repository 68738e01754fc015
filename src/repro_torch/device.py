"""Device rule of the port: entry points run on the GPU unless told otherwise.

No counterpart in ``src/repro/`` (JAX picks its backend globally).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises when a CUDA device is asked for and
    there is none: nothing carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and torch.cuda.is_available()"
                " is False; pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
