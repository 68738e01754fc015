"""Rule registry: one instance per invariant, in catalog order.

Counterpart of ``src/repro/analysis/rules/__init__.py``: the same six
rules in the same order.  ``tests/test_torch_analysis.py`` holds each rule
to the reference's on every fixture of ``tests/test_analysis.py``.
"""
from .determinism import DeterminismRule
from .jit import JitPurityRule
from .kv import KVPairingRule
from .ledger import LedgerDisciplineRule
from .regionkey import RegionKeyRule
from .unused import UnusedNameRule

ALL_RULES = (
    KVPairingRule(),
    LedgerDisciplineRule(),
    JitPurityRule(),
    RegionKeyRule(),
    DeterminismRule(),
    UnusedNameRule(),
)

__all__ = ["ALL_RULES", "KVPairingRule", "LedgerDisciplineRule",
           "JitPurityRule", "RegionKeyRule", "DeterminismRule",
           "UnusedNameRule"]
