"""Physical implementations (access paths) of LLM ORDER BY.

path             paper anchor
---------------  ------------------------------------------------------
pointwise        Sec. 3.1 — one scoring call per key
ext_pointwise    Sec. 3.1, Alg. 1 — m keys/call, adaptive batch size
quick            Sec. 3.2, Alg. 2 & 3 — pivot comparisons + peer voting
ext_bubble       Sec. 3.2 — RankGPT sliding-window passes
ext_merge        Sec. 3.2, Alg. 4 & 5 — semantic-aware external merge

Every path executes against the same Oracle verbs (semantic black box) and
emits *rounds* of independent calls for batched serving (DESIGN.md).

Counterpart of ``src/repro/core/access_paths/__init__.py`` (copied; only imports and
cross-references point at the port)."""
from .base import (AccessPath, Ordering, PathParams, available_paths,
                   make_path, register)
from .pointwise import ExternalPointwise, Pointwise
from .quicksort import QuickSort
from .bubble import ExternalBubbleSort
from .merge import ExternalMergeSort

__all__ = [
    "AccessPath", "Ordering", "PathParams", "available_paths", "make_path",
    "register", "Pointwise", "ExternalPointwise", "QuickSort",
    "ExternalBubbleSort", "ExternalMergeSort",
]
