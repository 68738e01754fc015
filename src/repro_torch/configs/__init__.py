"""Architecture configs (one module per arch) + registry.

Counterpart of ``src/repro/configs/``.  Each module exposes ``full()`` (the
published hyper-parameters) and ``reduced()`` (same family, small dims, for
the CPU tests).  Every id of the reference is listed.
"""
from .registry import ARCH_IDS, get_config, get_reduced, list_archs

__all__ = ["ARCH_IDS", "get_config", "get_reduced", "list_archs"]
