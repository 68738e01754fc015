"""Small shared AST helpers for the invariant rules.

Everything here is deliberately syntactic: rules match dotted-name shapes
(``self.pool.incref`` -> ``"self.pool.incref"``) rather than doing import
resolution, and compensate with narrow patterns + per-line suppressions.

Counterpart of ``src/repro/analysis/astutil.py``, scoped to the port (see
``framework.in_src``).
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional


def dotted_name(node: ast.expr) -> Optional[str]:
    """``a.b.c`` -> ``"a.b.c"``; None when any segment is not a Name/Attribute."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def call_name(call: ast.Call) -> Optional[str]:
    """Dotted name of a call's callee, or None for computed callees."""
    return dotted_name(call.func)


def last_segment(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def build_parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    return {child: parent
            for parent in ast.walk(tree)
            for child in ast.iter_child_nodes(parent)}


def ancestors(node: ast.AST, parents: dict[ast.AST, ast.AST]) -> Iterator[ast.AST]:
    """Yield node's ancestors innermost-first (excluding node itself)."""
    cur = parents.get(node)
    while cur is not None:
        yield cur
        cur = parents.get(cur)


def enclosing_statement(node: ast.AST,
                        parents: dict[ast.AST, ast.AST]) -> Optional[ast.stmt]:
    """The outermost statement whose parent is a statement-list holder.

    I.e. the simple statement that contains ``node``, suitable for
    "what is the next statement after this one" questions.
    """
    cur: Optional[ast.AST] = node
    while cur is not None:
        parent = parents.get(cur)
        if isinstance(cur, ast.stmt) and _holds_stmt_list(parent, cur):
            return cur
        cur = parent
    return None


def _holds_stmt_list(parent: Optional[ast.AST], child: ast.stmt) -> bool:
    if parent is None:
        return False
    for field in ("body", "orelse", "finalbody"):
        block = getattr(parent, field, None)
        if isinstance(block, list) and child in block:
            return True
    if isinstance(parent, ast.Try) and child in parent.handlers:  # pragma: no cover
        return True
    return False


def following_statement(stmt: ast.stmt,
                        parents: dict[ast.AST, ast.AST]) -> Optional[ast.stmt]:
    """The statement immediately after ``stmt`` in its enclosing block."""
    parent = parents.get(stmt)
    if parent is None:
        return None
    for field in ("body", "orelse", "finalbody"):
        block = getattr(parent, field, None)
        if isinstance(block, list) and stmt in block:
            i = block.index(stmt)
            return block[i + 1] if i + 1 < len(block) else None
    return None


def calls_in(nodes) -> Iterator[ast.Call]:
    for n in nodes if isinstance(nodes, list) else [nodes]:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Call):
                yield sub


def callee_attr(call: ast.Call) -> Optional[str]:
    """Final attribute/name of the callee: ``self.pool.incref(..)`` -> ``incref``."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None
