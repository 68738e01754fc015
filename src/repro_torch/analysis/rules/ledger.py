"""ledger-discipline: billing happens in core/oracles/, rounds always finish.

Two sub-invariants:

1. Ledger mutation (``*.ledger.charge(...)``) and billing-record /
   ledger construction (``CallRecord(...)``, ``TokenLedger(...)``) are only
   legal inside ``src/repro_torch/core/oracles/``.  Everything above bills
   *through* an Oracle verb so per-query reconciliation
   (SemanticMemo.reconciled_records, interleaved==solo ledger identity)
   keeps holding — a direct charge from serving or an access path would be
   invisible to the memo and silently break byte-identical billing.

2. Any function that calls ``begin_probe_round`` must also call
   ``finish_probe_round`` with at least one of those finish calls inside a
   ``finally`` block.  ``begin`` bills and enqueues the round immediately;
   abandoning the token leaves billed-but-unserved probes in the scheduler
   (the executor.tick bug this invariant closed).

Cascade extensions (core/oracles/cascade.py): the draft→large escalation
machinery moves billing decisions into a mid-pump callback, so two more
billing sites are confined to the oracle layer:

3. ``*.charge(..., tier=...)`` — tier-tagged CallRecord construction —
   is flagged outside ``core/oracles/`` regardless of the receiver's
   name.  A tier tag from serving or an access path would let a
   non-oracle layer decide which price sheet a record books against.

4. ``*.submit_cascade_round(...)`` is flagged outside ``core/oracles/``:
   its ``escalate`` callback bills the large wave, so a caller above the
   oracle layer would be a billing site in disguise.  (Deferred cascade
   rounds still flow through ``begin/finish_probe_round``, so invariant 2
   covers their pairing — escalation waves resolve inside the same
   token's finish, which must sit in a ``finally``.)

Counterpart of ``src/repro/analysis/rules/ledger.py``, scoped to the port (see
``framework.in_src``).
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..astutil import callee_attr, calls_in, dotted_name
from ..framework import Finding, ModuleSource, Rule, in_src

ALLOWED_PREFIX = "src/repro_torch/core/oracles/"
BILLING_CTORS = frozenset({"CallRecord", "TokenLedger"})


class LedgerDisciplineRule(Rule):
    id = "ledger-discipline"
    summary = ("ledger.charge()/CallRecord()/TokenLedger()/charge(tier=...)/"
               "submit_cascade_round() only inside core/oracles/; "
               "begin_probe_round paired with a finish_probe_round in a "
               "finally block")

    def applies(self, relpath: str) -> bool:
        return in_src(relpath)

    def check(self, mod: ModuleSource) -> Iterable[Finding]:
        allowed = ALLOWED_PREFIX in mod.relpath.replace("\\", "/")
        if not allowed:
            yield from self._check_billing_sites(mod)
        yield from self._check_round_pairing(mod)

    def _check_billing_sites(self, mod: ModuleSource) -> Iterable[Finding]:
        for call in calls_in(mod.tree):
            name = dotted_name(call.func)
            attr = callee_attr(call)
            if name:
                parts = name.split(".")
                if parts[-1] == "charge" and "ledger" in parts[:-1]:
                    yield self.finding(
                        mod, call,
                        "direct ledger.charge() outside core/oracles/ — "
                        "bill through an Oracle verb so memo reconciliation "
                        "sees the spend")
            if (attr == "charge" and isinstance(call.func, ast.Attribute)
                    and any(kw.arg == "tier" for kw in call.keywords)):
                yield self.finding(
                    mod, call,
                    "tier-tagged charge(tier=...) outside core/oracles/ — "
                    "which price sheet a record books against is an "
                    "oracle-layer decision")
            if attr == "submit_cascade_round" and isinstance(call.func,
                                                             ast.Attribute):
                yield self.finding(
                    mod, call,
                    "submit_cascade_round() outside core/oracles/ — its "
                    "escalate callback bills the large wave, making the "
                    "caller a billing site")
            if attr in BILLING_CTORS and isinstance(call.func, ast.Name):
                yield self.finding(
                    mod, call,
                    f"{attr}() constructed outside core/oracles/ — billing "
                    f"records and ledgers are owned by the oracle layer")

    def _check_round_pairing(self, mod: ModuleSource) -> Iterable[Finding]:
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in ("begin_probe_round", "finish_probe_round"):
                continue  # the definitions themselves
            begins = [c for c in calls_in(list(fn.body))
                      if callee_attr(c) == "begin_probe_round"
                      and isinstance(c.func, ast.Attribute)]
            if not begins:
                continue
            finishes = [c for c in calls_in(list(fn.body))
                        if callee_attr(c) == "finish_probe_round"]
            if not finishes:
                yield self.finding(
                    mod, begins[0],
                    "begin_probe_round() with no finish_probe_round() in "
                    "this function — the billed round is never served")
                continue
            if not any(self._in_finally(mod, c) for c in finishes):
                yield self.finding(
                    mod, begins[0],
                    "begin_probe_round() but no finish_probe_round() call "
                    "is inside a finally block — an exception mid-tick "
                    "abandons billed rounds")

    @staticmethod
    def _in_finally(mod: ModuleSource, call: ast.Call) -> bool:
        prev: ast.AST = call
        for anc in mod.ancestors(call):
            if isinstance(anc, ast.Try) and prev in anc.finalbody:
                return True
            if isinstance(anc, ast.stmt):
                prev = anc
        return False
