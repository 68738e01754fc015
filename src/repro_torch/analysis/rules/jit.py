"""jit-purity: no host-side impurity or traced-value branching under trace.

Functions handed to ``jax.jit`` / ``pl.pallas_call`` / ``shard_map`` run
once at trace time; impure calls (``time.*``, stdlib ``random``,
``datetime.now``, ``print``, ``np.random``) execute at trace time only and
silently freeze into the compiled graph, while ``.item()`` forces a host
sync that defeats async dispatch.  A Python ``if`` on a name bound from a
``jnp`` op is a trace-time error (ConcretizationTypeError) at best and a
shape-dependent miscompile at worst — the rule flags it statically so the
mistake never reaches a device.

Resolution is same-module and syntactic: decorator forms ``@jax.jit``,
``@partial(jax.jit, ...)`` (including aliased ``@_partial(_shard_map, ...)``
as in models/moe.py), and call forms ``jit(f)`` / ``pl.pallas_call(k, ...)``
where ``f`` is a local ``def``/``lambda``, a ``partial`` thereof, or a name
ASSIGNED from such a ``partial`` — which covers the serving engine's
mesh-jitted closures (``jax.jit(_decode_paged_sharded, ...)``: a local def
wrapping the model call in a ``shard_context``).  Callees we cannot resolve
(bound methods like ``lm.prefill``) are skipped — a documented limitation,
not a pass.

Donation pairing: every wrapper call with a ``donate_argnums`` keyword the
rule can resolve to literal indices (literal tuple/int, or a name assigned
one — the engine's ``donate = (1,)``) is checked against what it donates.
A resolvable local def must donate a parameter whose NAME reads as a
reusable device buffer (arena/cache/state — the serving arenas and the
train loop's optimizer state); donating ``params`` or a token batch
invalidates the caller's copy mid-flight.  Method references are checked by
name: ``decode_step_paged``/``decode_step`` may donate exactly their
arena/cache argument (argnum 1), while ``prefill``/``prefill_cont`` must
never donate — prefix-cache entries alias their output caches.  Computed
donate expressions (ternaries, ``**kw``) are skipped like unresolvable
callees.

Counterpart of ``src/repro/analysis/rules/jit.py``, scoped to the port (see
``framework.in_src``).
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from ..astutil import dotted_name, last_segment
from ..framework import Finding, ModuleSource, Rule

WRAPPERS = frozenset({"jit", "pallas_call", "shard_map"})
BANNED_BARE = frozenset({"print", "input", "breakpoint"})
DATETIME_NOW = frozenset({"now", "utcnow", "today"})

# donation pairing: method-name contracts for the serving/dryrun jits.  The
# VALUE is the set of argnums that hold the donatable arena/cache pytree.
DONATABLE_METHODS = {"decode_step_paged": frozenset({1}),
                     "decode_step": frozenset({1})}
# prefill outputs are aliased by prefix-cache entries (engine LRU holds
# direct references): donating their inputs/outputs is always a bug
NON_DONATABLE_METHODS = frozenset({"prefill", "prefill_cont"})
# a donated local-def parameter must read as a reusable device buffer
DONATABLE_PARAM_HINTS = ("arena", "cache", "state")


class JitPurityRule(Rule):
    id = "jit-purity"
    summary = ("bodies traced by jax.jit/pallas_call/shard_map must not call "
               "time/random/datetime.now/print/.item(), nor branch with "
               "Python if on names bound from jnp ops")

    def check(self, mod: ModuleSource) -> Iterable[Finding]:
        defs = _local_defs(mod.tree)
        consts = _const_assigns(mod.tree)
        seen = set()
        targets = []

        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_wrapper_decorator(d) for d in node.decorator_list):
                    targets.append(node)
            elif isinstance(node, ast.Call) and _is_wrapper(node.func) \
                    and node.args:
                fn = _resolve(node.args[0], defs)
                if fn is not None:
                    targets.append(fn)
                yield from self._check_donation(mod, node, defs, consts)

        for fn in targets:
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            yield from self._check_body(mod, fn)

    def _check_donation(self, mod: ModuleSource, call: ast.Call,
                        defs: dict, consts: dict) -> Iterable[Finding]:
        kw = next((k for k in call.keywords
                   if k.arg == "donate_argnums"), None)
        if kw is None:
            return
        idxs = _const_tuple(kw.value, consts)
        if idxs is None:       # ternary / computed — skipped, not a pass
            return
        fn = _resolve(call.args[0], defs)
        if fn is not None:
            params = [a.arg for a in fn.args.args]
            label = getattr(fn, "name", "<lambda>")
            for i in idxs:
                pname = params[i] if 0 <= i < len(params) else None
                if pname is None or not any(
                        h in pname.lower() for h in DONATABLE_PARAM_HINTS):
                    yield self.finding(
                        mod, call,
                        f"donate_argnums={tuple(idxs)} on '{label}' donates "
                        f"parameter {pname!r}, which does not look like a "
                        f"reusable arena/cache/state buffer — donation "
                        f"invalidates the caller's copy")
            return
        mname = _method_name(call.args[0])
        if mname is None:
            return
        if mname in NON_DONATABLE_METHODS and idxs:
            yield self.finding(
                mod, call,
                f"donating into '{mname}' — prefill caches are aliased by "
                f"prefix-cache entries and must never be donated")
        elif mname in DONATABLE_METHODS:
            bad = set(idxs) - DONATABLE_METHODS[mname]
            if bad:
                yield self.finding(
                    mod, call,
                    f"'{mname}' may only donate its arena argument (argnums "
                    f"{sorted(DONATABLE_METHODS[mname])}), got {tuple(idxs)}")

    def _check_body(self, mod: ModuleSource, fn) -> Iterable[Finding]:
        label = getattr(fn, "name", "<lambda>")
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                msg = _impure_call(node)
                if msg:
                    yield self.finding(
                        mod, node,
                        f"{msg} inside traced body '{label}' — runs once at "
                        f"trace time / forces host sync")
        traced = _jnp_bound_names(fn)
        if not traced:
            return
        for node in ast.walk(fn):
            test = None
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                test = node.test
            if test is None:
                continue
            hit = _traced_operand(test, traced)
            if hit:
                yield self.finding(
                    mod, node,
                    f"Python branch on '{hit}' (bound from a jnp op) inside "
                    f"traced body '{label}' — use jnp.where/lax.cond")


# --------------------------------------------------------------- matching

def _is_wrapper(expr: ast.expr) -> bool:
    name = dotted_name(expr)
    return name is not None and last_segment(name).lstrip("_") in WRAPPERS


def _is_wrapper_decorator(dec: ast.expr) -> bool:
    if _is_wrapper(dec):                      # @jax.jit
        return True
    if isinstance(dec, ast.Call):
        if _is_wrapper(dec.func):             # @jax.jit(...)
            return True
        name = dotted_name(dec.func)          # @partial(jax.jit, ...)
        if name and last_segment(name).lstrip("_") == "partial" \
                and dec.args and _is_wrapper(dec.args[0]):
            return True
    return False


def _local_defs(tree: ast.AST) -> dict:
    defs = {}
    pending = []          # names assigned from partial(...): resolve after
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Lambda):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    defs[t.id] = node.value
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = dotted_name(node.value.func)
            if name and last_segment(name).lstrip("_") == "partial":
                pending.append(node)
    # second pass: f2 = partial(f, ...) resolves through defs collected above
    for node in pending:
        fn = _resolve(node.value, defs)
        if fn is not None:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    defs.setdefault(t.id, fn)
    return defs


def _resolve(expr: ast.expr, defs: dict):
    if isinstance(expr, ast.Lambda):
        return expr
    if isinstance(expr, ast.Name):
        return defs.get(expr.id)
    if isinstance(expr, ast.Call):            # jit(partial(f, ...))
        name = dotted_name(expr.func)
        if name and last_segment(name).lstrip("_") == "partial" and expr.args:
            return _resolve(expr.args[0], defs)
    return None


def _method_name(expr: ast.expr) -> Optional[str]:
    """Last segment of the callee a jit call wraps: ``lm.decode_step`` ->
    ``decode_step``, peeling one ``partial(...)`` layer if present."""
    if isinstance(expr, ast.Call):
        name = dotted_name(expr.func)
        if name and last_segment(name).lstrip("_") == "partial" and expr.args:
            return _method_name(expr.args[0])
        return None
    name = dotted_name(expr)
    return last_segment(name) if name else None


def _const_assigns(tree: ast.AST) -> dict:
    assigns = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            assigns[node.targets[0].id] = node.value
    return assigns


def _const_tuple(expr, consts: dict, depth: int = 0):
    """Resolve a donate_argnums expression to a tuple of ints, or None when
    it is computed (ternary, attribute, call) — those sites are skipped."""
    if expr is None or depth > 3:
        return None
    if isinstance(expr, ast.Constant):
        v = expr.value
        return (v,) if isinstance(v, int) and not isinstance(v, bool) else None
    if isinstance(expr, (ast.Tuple, ast.List)):
        out = []
        for e in expr.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int) \
                    and not isinstance(e.value, bool):
                out.append(e.value)
            else:
                return None
        return tuple(out)
    if isinstance(expr, ast.Name):
        return _const_tuple(consts.get(expr.id), consts, depth + 1)
    return None


def _impure_call(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Name) and call.func.id in BANNED_BARE:
        return f"impure call {call.func.id}()"
    name = dotted_name(call.func)
    if name:
        parts = name.split(".")
        if parts[0] == "time" and len(parts) > 1:
            return f"impure call {name}()"
        if parts[0] == "datetime" and parts[-1] in DATETIME_NOW:
            return f"impure call {name}()"
        if parts[0] == "random" and len(parts) > 1:
            return f"nondeterministic call {name}()"
        if len(parts) >= 3 and parts[0] in ("np", "numpy") \
                and parts[1] == "random":
            return f"nondeterministic call {name}()"
    if isinstance(call.func, ast.Attribute) and call.func.attr == "item" \
            and not call.args:
        return "device sync .item()"
    return None


def _jnp_bound_names(fn) -> frozenset:
    traced = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, ast.Call):
            continue
        name = dotted_name(node.value.func)
        if not name:
            continue
        if name.split(".")[0] == "jnp" or name.startswith("jax.numpy."):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    traced.add(t.id)
                elif isinstance(t, ast.Tuple):
                    traced.update(e.id for e in t.elts
                                  if isinstance(e, ast.Name))
    return frozenset(traced)


def _traced_operand(test: ast.expr, traced: frozenset) -> Optional[str]:
    """Direct traced-name operands only: x.ndim / len(x) are trace-static."""
    if isinstance(test, ast.Name):
        return test.id if test.id in traced else None
    if isinstance(test, ast.Compare):
        for operand in [test.left, *test.comparators]:
            if isinstance(operand, ast.Name) and operand.id in traced:
                return operand.id
        return None
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            hit = _traced_operand(v, traced)
            if hit:
                return hit
        return None
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _traced_operand(test.operand, traced)
    return None
