"""Counterpart of ``src/repro/core/`` (copied; only imports and docstring
cross-references differ).  The paper's primary contribution: the LLM ORDER BY semantic operator,
its physical access paths, and the budget-aware access-path optimizer."""
from .types import InvalidOutputError, Key, SortResult, SortSpec, as_keys
from .operator import OrderQuery, Table, llm_order_by, llm_order_by_many
from .access_paths import (AccessPath, PathParams, available_paths, make_path)
from .executor import (ComparePairs, InquireEach, PlanCancelled,
                       ProbePlanExecutor, RankWindows, ScoreBatches,
                       ScoreEach, SerialProbe, drive_plan)
from .optimizer.optimizer import (AccessPathOptimizer, OptimizerConfig,
                                  OptimizerReport)
from .optimizer.cost_model import CandidateSpec, default_candidates
from .oracles.base import (CASCADE_70B, GPT41, LLAMA70B, LLAMA405B, Oracle,
                           PriceSheet, TieredPrices, TokenLedger)
from .oracles.simulated import (FACTUAL, REASONING, SENTIMENT, ExactOracle,
                                FlakyOracle, OracleProfile, SimulatedOracle)
from .oracles.cascade import (CascadeOracle, DRAFT_1p6B,
                              SimulatedCascadeOracle)
from .oracles.cache import CachingOracle
from . import datasets, metrics

__all__ = [
    "InvalidOutputError", "Key", "SortResult", "SortSpec", "as_keys",
    "OrderQuery", "Table", "llm_order_by", "llm_order_by_many",
    "AccessPath", "PathParams", "available_paths",
    "make_path", "ComparePairs", "InquireEach", "PlanCancelled",
    "ProbePlanExecutor", "RankWindows", "ScoreBatches", "ScoreEach",
    "SerialProbe", "drive_plan",
    "AccessPathOptimizer", "OptimizerConfig", "OptimizerReport",
    "CandidateSpec", "default_candidates", "Oracle", "PriceSheet",
    "TieredPrices", "TokenLedger", "GPT41", "LLAMA70B", "LLAMA405B",
    "CASCADE_70B", "FACTUAL", "REASONING", "SENTIMENT", "ExactOracle",
    "FlakyOracle", "OracleProfile", "SimulatedOracle", "CascadeOracle",
    "SimulatedCascadeOracle", "DRAFT_1p6B", "CachingOracle", "datasets",
    "metrics",
]
