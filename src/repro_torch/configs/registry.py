"""Arch id -> config registry.

Counterpart of ``src/repro/configs/registry.py``.  Lists only the
architectures the port can run; the reference's other ids raise
``NotImplementedError`` naming the slice that brings them.  ``ladder()``
(the model-cascade rung order) comes with ``phi4-mini-3.8b`` and
``attn_impl="qchunk"``: the port's ``core/`` needs none of it.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

_MODULES = {
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1p6b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1p3b",
}

_LATER = {
    "phi4-mini-3.8b": "the slice of the remaining pure-attn configs and "
                      "attn_impl='qchunk' (needs no new block kind)",
    "seamless-m4t-medium": "the encoder-decoder slice",
    "qwen2-vl-7b": "the M-RoPE / embeds-input slice",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch in _LATER:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet: it comes with "
            f"{_LATER[arch]}")
    return import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).full()


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def list_archs() -> list[str]:
    return list(ARCH_IDS)
