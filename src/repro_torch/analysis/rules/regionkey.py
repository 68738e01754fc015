"""region-key-unification: prefix-region keys come from ServeEngine._region_key.

A drift bug: probe routing, paged admission and prefetch once
each built the region tuple ``(prefix_ids, window - len(prefix) - len(sfx))``
by hand; one site computing the window differently made a warm region look
cold (wasted fills) or, worse, routed rows to a stale cached region.  All
construction now goes through ``ServeEngine._region_key`` — this rule keeps
it that way by flagging the tuple's distinctive shape anywhere else:
a 2-tuple whose second element is a subtraction involving ``len(...)``.

Counterpart of ``src/repro/analysis/rules/regionkey.py``, scoped to the port (see
``framework.in_src``).
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..framework import Finding, ModuleSource, Rule, in_src


class RegionKeyRule(Rule):
    id = "region-key-unification"
    summary = ("no ad-hoc (prefix_ids, window - len(...)) region-key tuples "
               "outside ServeEngine._region_key")

    def applies(self, relpath: str) -> bool:
        return in_src(relpath)

    def check(self, mod: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Tuple) or len(node.elts) != 2:
                continue
            if not _is_len_subtraction(node.elts[1]):
                continue
            if any(isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and a.name == "_region_key" for a in mod.ancestors(node)):
                continue
            yield self.finding(
                mod, node,
                "ad-hoc region-key tuple (ids, window - len(...)) — route "
                "through ServeEngine._region_key so keys cannot drift")


def _is_len_subtraction(expr: ast.expr) -> bool:
    """A BinOp subtree using Sub that contains a len(...) call."""
    if not isinstance(expr, ast.BinOp):
        return False
    has_sub = any(isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)
                  for n in ast.walk(expr))
    has_len = any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                  and n.func.id == "len" for n in ast.walk(expr))
    return has_sub and has_len
