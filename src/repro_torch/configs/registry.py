"""Arch id -> config registry (``--arch <id>`` everywhere).

Counterpart of ``src/repro/configs/registry.py``: the same ids in the same
order, and ``ladder()``, the model-cascade rung order.  An unknown id raises
``KeyError``, as the reference's lookup does.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

_MODULES = {
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3p8b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1p6b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1p3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return import_module(_MODULES[arch]).full()


def get_reduced(arch: str) -> ModelConfig:
    return import_module(_MODULES[arch]).reduced()


def list_archs() -> list[str]:
    return list(ARCH_IDS)


# Model-cascade rung order (core/oracles/cascade.py): draft-first probe
# execution runs wave 1 on an early rung's engine and escalates low-margin
# rows to a later rung.  Ordered smallest to largest.
_LADDER = ("stablelm-1.6b", "llama3-8b", "mixtral-8x22b")


def ladder() -> list[str]:
    """Arch ids of the draft -> large cascade ladder, smallest first."""
    return list(_LADDER)
