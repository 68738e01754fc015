"""kv-pairing: every KV refcount acquire must release on ALL paths.

The paged KV pool (serving/kv_pool.py) hands out per-block refcounts;
a raised exception between an ``incref``/``lease`` and its matching
``decref``/``release`` strands blocks forever — the pool never reclaims
them and long-running serving eventually hits PoolExhausted (the leak
class the round-pin try/finally and the prefetch_prefixes / paged_admit
fixes closed).

The rule is lexical, not dataflow: an acquiring call is OK when it is
(a) inside a ``try`` body whose ``finally`` performs a release,
(b) the statement *immediately before* such a ``try`` (the standard
    acquire-then-guard idiom: nothing can raise in between), or
(c) inside a ``with`` block (context managers own their cleanup).
Call sites that intentionally transfer ownership to their caller (e.g.
``_fill_prefix_entries``'s pin closure) carry ``# lint: disable=kv-pairing``
with a comment naming the owner.

Counterpart of ``src/repro/analysis/rules/kv.py``, scoped to the port (see
``framework.in_src``).
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..astutil import callee_attr, calls_in, enclosing_statement, following_statement
from ..framework import Finding, ModuleSource, Rule, in_src

#: method names that take a refcount / pool lease.  ``alloc`` joined the
#: set with the preemption work: suspend/resume moves whole block runs in
#: and out of the pool, so a raw alloc whose blocks never reach a row (or
#: a rollback) is exactly the stranded-pin class this rule exists for.
ACQUIRES = frozenset({"alloc", "incref", "lease", "_lease_probe_blocks",
                      "_fill_prefix_entries"})
#: method names that give one back.
RELEASES = frozenset({"decref", "release", "_release_lease", "_release_pins",
                      "free"})


class KVPairingRule(Rule):
    id = "kv-pairing"
    summary = ("incref/lease call sites must reach a decref/release on all "
               "paths (finally block, adjacent try/finally, or with block)")

    def applies(self, relpath: str) -> bool:
        return in_src(relpath)

    def check(self, mod: ModuleSource) -> Iterable[Finding]:
        for call in calls_in(mod.tree):
            name = callee_attr(call)
            if name not in ACQUIRES:
                continue
            # the definition of an acquire method is not a call site
            if isinstance(call.func, ast.Name):
                continue
            if self._guarded(mod, call):
                continue
            yield self.finding(
                mod, call,
                f"{name}() without a finally-guarded release on this path "
                f"— wrap in try/finally with "
                f"{'/'.join(sorted(RELEASES))} or move the acquire "
                f"immediately before an existing try/finally")

    def _guarded(self, mod: ModuleSource, call: ast.Call) -> bool:
        # (a)/(c): enclosing try-with-releasing-finally, or a with block.
        prev = call
        for anc in mod.ancestors(call):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                return True
            if isinstance(anc, ast.Try) and prev in anc.body \
                    and _block_releases(anc.finalbody):
                return True
            if isinstance(anc, ast.stmt):
                prev = anc
        # (b): the next statement is a try whose finally releases.
        stmt = enclosing_statement(call, mod.parents)
        if stmt is not None:
            nxt = following_statement(stmt, mod.parents)
            if isinstance(nxt, ast.Try) and _block_releases(nxt.finalbody):
                return True
        return False


def _block_releases(block: list) -> bool:
    return any(callee_attr(c) in RELEASES for c in calls_in(block))
