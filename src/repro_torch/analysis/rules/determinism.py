"""determinism: no process-salted hashing or unseeded RNG in src/repro_torch/.

The class of bug: quicksort's peer sampling once seeded from builtin ``hash()``,
which is salted by PYTHONHASHSEED — two runs of the same query produced
different probe orders (and therefore different ledgers) across processes.
The fix was a blake2b digest (``core.oracles.cache.stable_key``).  This
rule bans the whole class inside the shipped package:

* builtin ``hash(...)``,
* stdlib ``random.*`` except an explicitly seeded ``random.Random(seed)``
  (``jax.random`` is keyed and fine; it does not match the dotted root),
* ``np.random.*`` legacy global API, and ``np.random.default_rng()``
  without a seed argument (seeded ``default_rng(seed)`` / ``Generator`` /
  ``SeedSequence`` / ``PCG64`` / ``Philox`` constructions are fine).

Counterpart of ``src/repro/analysis/rules/determinism.py``, scoped to the port (see
``framework.in_src``).
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..astutil import dotted_name
from ..framework import Finding, ModuleSource, Rule, in_src

_SEEDED_CTORS = frozenset({"Generator", "SeedSequence", "PCG64", "Philox",
                           "MT19937", "bit_generator"})


class DeterminismRule(Rule):
    id = "determinism"
    summary = ("no builtin hash(), stdlib random, or unseeded np.random in "
               "src/repro_torch/ — use blake2b stable_key / seeded default_rng")

    def applies(self, relpath: str) -> bool:
        return in_src(relpath)

    def check(self, mod: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and node.func.id == "hash":
                yield self.finding(
                    mod, node,
                    "builtin hash() is PYTHONHASHSEED-salted — use "
                    "core.oracles.cache.stable_key (blake2b) instead")
                continue
            name = dotted_name(node.func)
            if not name:
                continue
            parts = name.split(".")
            if parts[0] == "random" and len(parts) > 1:
                if parts[1] == "Random" and node.args:
                    continue  # explicitly seeded
                yield self.finding(
                    mod, node,
                    f"{name}() draws from process-global stdlib RNG — seed "
                    f"an np.random.default_rng(seed) instead")
            elif len(parts) >= 3 and parts[0] in ("np", "numpy") \
                    and parts[1] == "random":
                tail = parts[2]
                if tail in _SEEDED_CTORS:
                    continue
                if tail == "default_rng" and node.args:
                    continue
                yield self.finding(
                    mod, node,
                    f"{name}() is unseeded/legacy np.random — pass an "
                    f"explicit seed to np.random.default_rng")
