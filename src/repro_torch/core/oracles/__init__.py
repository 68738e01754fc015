"""Counterpart of ``src/repro/core/oracles/__init__.py`` (copied; only imports and
cross-references point at the port)."""
from .base import (Oracle, PriceSheet, TieredPrices, TokenLedger, LLAMA70B,
                   LLAMA405B, GPT41, STABLELM2, CASCADE_70B)
from .simulated import ExactOracle, FlakyOracle, OracleProfile, SimulatedOracle
from .cascade import (CascadeOracle, DRAFT_1p6B, SimulatedCascadeOracle,
                      probe_margin)
from .cache import CachingOracle, SemanticMemo, canon_criteria, stable_key

__all__ = ["Oracle", "PriceSheet", "TieredPrices", "TokenLedger", "LLAMA70B",
           "LLAMA405B", "GPT41", "STABLELM2", "CASCADE_70B", "ExactOracle",
           "FlakyOracle", "OracleProfile", "SimulatedOracle", "CascadeOracle",
           "SimulatedCascadeOracle", "DRAFT_1p6B", "probe_margin",
           "CachingOracle", "SemanticMemo", "canon_criteria", "stable_key"]
