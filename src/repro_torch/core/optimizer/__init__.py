"""Counterpart of ``src/repro/core/optimizer/__init__.py`` (copied; only imports and
cross-references point at the port)."""
from .optimizer import (AccessPathOptimizer, OptimizerConfig,
                        OptimizerDriver, OptimizerReport)
from .cost_model import CandidateSpec, default_candidates, estimate_full_cost
from .borda import borda_consensus, borda_matrix, borda_scores
from .membership import is_world_knowledge, membership_rate
from .judge import judge_select

__all__ = ["AccessPathOptimizer", "OptimizerConfig", "OptimizerDriver",
           "OptimizerReport",
           "CandidateSpec", "default_candidates", "estimate_full_cost",
           "borda_consensus", "borda_matrix", "borda_scores",
           "is_world_knowledge", "membership_rate", "judge_select"]
