"""unused-name: imports that nothing in the module references.

Dead imports are how dead code starts (an orphaned helper goes, its
import lingers).  The rule is intentionally narrow — imports
only, matched against every ``Name`` load in the module plus ``__all__``
strings — so it has no false positives on attribute-only usage
(``import os`` + ``os.environ`` counts as used via the ``os`` Name node).

Exempt: ``from __future__ import ...`` (semantic, not a binding in the
usual sense), ``import *``, and ``__init__.py`` files entirely (re-export
modules bind names precisely so other modules can import them).

Counterpart of ``src/repro/analysis/rules/unused.py``, scoped to the port (see
``framework.in_src``).
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..framework import Finding, ModuleSource, Rule


class UnusedNameRule(Rule):
    id = "unused-name"
    summary = "imported names never referenced in the module (re-exports exempt)"

    def applies(self, relpath: str) -> bool:
        return not relpath.replace("\\", "/").endswith("__init__.py")

    def check(self, mod: ModuleSource) -> Iterable[Finding]:
        imported = []  # (bound_name, display_name, lineno)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    imported.append((bound, alias.name, node.lineno))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    bound = alias.asname or alias.name
                    imported.append((bound, alias.name, node.lineno))
        if not imported:
            return

        used = {n.id for n in ast.walk(mod.tree) if isinstance(n, ast.Name)}
        used |= _dunder_all(mod.tree)

        for bound, display, lineno in imported:
            if bound not in used:
                yield self.finding(
                    mod, lineno,
                    f"'{display}' imported but unused")


def _dunder_all(tree: ast.AST) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                    names.add(sub.value)
    return names
