"""repro_torch.analysis — AST-based invariant linter for the PyTorch port.

Every guarantee the serving stack makes — byte-identical orderings, exact
per-query ledger reconciliation (SemanticMemo first-requester-pays), zero
KV block leaks — rests on conventions that used to be enforced only by
runtime asserts inside specific tests.  This package locks them in
*statically*: a small rule framework (``framework.py``) walks every file's
AST and reports :class:`Finding`\\ s for code that violates one of the
repo's hard-won invariants (``rules/``).  Run it as

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch tests chip_smoke.py

Pure stdlib (``ast`` only — no torch or jax import), so it runs wherever
Python does.  Rule catalog, suppression and baseline
conventions: DESIGN.md "Static analysis".

Counterpart of ``src/repro/analysis/__init__.py``: the same six rules,
messages, suppression syntax, baseline format and exit codes, with the
``src`` rules scoped to ``src/repro_torch/`` (``framework.in_src``).
"""
from .framework import (Finding, Report, check_source, load_baseline,
                        run_paths, split_new, write_baseline)
from .rules import ALL_RULES

__all__ = ["Finding", "Report", "ALL_RULES", "check_source", "run_paths",
           "load_baseline", "write_baseline", "split_new"]
