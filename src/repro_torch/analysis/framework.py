"""Rule framework: findings, suppressions, baseline, file walking, reports.

A :class:`Rule` inspects one parsed module and yields :class:`Finding`\\ s.
The framework owns everything rules should not re-implement:

* per-line suppressions — ``# lint: disable=rule-a,rule-b`` (or ``all``) on
  the flagged line drops the finding; the framework counts what it dropped
  so suppressions stay visible in the report,
* an optional JSON baseline of accepted findings, matched by
  ``(rule, path, message)`` rather than line number so unrelated edits that
  shift lines don't resurrect baselined findings,
* deterministic ordering of files and findings (sorted paths, then
  line/rule), so output is byte-stable across runs and machines.

``check_source`` is the fixture entry point used by tests: it lints a
source string as if it lived at a given relative path.

Counterpart of ``src/repro/analysis/framework.py``, scoped to the port (see
``framework.in_src``).
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional, Sequence

from .astutil import ancestors as _ancestors
from .astutil import build_parents

_DISABLE_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_\-, ]+)")

#: rule id attached to files the linter cannot parse.
PARSE_ERROR = "parse-error"


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a specific location."""
    path: str
    line: int
    rule: str
    message: str

    def key(self) -> tuple:
        # line numbers churn with unrelated edits; baseline matching is
        # therefore (rule, path, message) only.
        return (self.rule, self.path, self.message)

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line,
                "rule": self.rule, "message": self.message}

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(path=str(d["path"]), line=int(d.get("line", 0)),
                   rule=str(d["rule"]), message=str(d["message"]))

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class ModuleSource:
    """One parsed file: source lines, AST, parent links, suppressions."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        self.parents = build_parents(self.tree)

    def ancestors(self, node: ast.AST):
        return _ancestors(node, self.parents)

    def suppressed_rules(self, line: int) -> frozenset:
        """Rule ids disabled on a given 1-based source line."""
        if not (1 <= line <= len(self.lines)):
            return frozenset()
        m = _DISABLE_RE.search(self.lines[line - 1])
        if not m:
            return frozenset()
        return frozenset(part.strip() for part in m.group(1).split(",")
                         if part.strip())

    def is_suppressed(self, finding: Finding) -> bool:
        rules = self.suppressed_rules(finding.line)
        return finding.rule in rules or "all" in rules


class Rule:
    """Base class: subclasses set ``id``/``summary`` and implement check()."""

    id: str = ""
    summary: str = ""

    def applies(self, relpath: str) -> bool:
        return True

    def check(self, mod: ModuleSource) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, mod: ModuleSource, node, message: str) -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 0)
        return Finding(path=mod.relpath, line=line, rule=self.id,
                       message=message)


def in_src(relpath: str) -> bool:
    """Scope helper: does this path live under the port's package?

    Substring match so absolute paths (CLI invoked from outside the repo
    root) scope the same as repo-relative ones."""
    return "src/repro_torch/" in relpath.replace("\\", "/")


@dataclass
class Report:
    """Aggregate result of a lint run."""
    findings: list = field(default_factory=list)   # surviving (not suppressed)
    suppressed: int = 0
    files: int = 0

    def sorted(self) -> list:
        return sorted(self.findings)


def check_module(mod: ModuleSource, rules: Sequence[Rule]) -> tuple[list, int]:
    """Run every applicable rule; returns (findings, n_suppressed)."""
    kept, dropped = [], 0
    for rule in rules:
        if not rule.applies(mod.relpath):
            continue
        for f in rule.check(mod):
            if mod.is_suppressed(f):
                dropped += 1
            else:
                kept.append(f)
    return kept, dropped


def check_source(text: str, relpath: str = "src/repro_torch/fixture.py",
                 rules: Optional[Sequence[Rule]] = None) -> list:
    """Lint a source string as if it lived at ``relpath`` (test entry point)."""
    if rules is None:
        from .rules import ALL_RULES
        rules = ALL_RULES
    mod = ModuleSource(relpath, text)
    findings, _ = check_module(mod, rules)
    return sorted(findings)


def iter_py_files(paths: Sequence[str], root: Optional[Path] = None):
    """Yield (abs_path, relpath) for every .py under the given paths, sorted."""
    root = root or Path.cwd()
    seen = set()
    for raw in paths:
        p = Path(raw)
        if not p.is_absolute():
            p = root / p
        candidates = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for f in candidates:
            if f.suffix != ".py" or "__pycache__" in f.parts:
                continue
            try:
                rel = f.relative_to(root).as_posix()
            except ValueError:
                rel = f.as_posix()
            if rel not in seen:
                seen.add(rel)
                yield f, rel


def run_paths(paths: Sequence[str], rules: Optional[Sequence[Rule]] = None,
              root: Optional[Path] = None) -> Report:
    """Lint every .py file under ``paths``; parse failures become findings."""
    if rules is None:
        from .rules import ALL_RULES
        rules = ALL_RULES
    report = Report()
    for abspath, rel in iter_py_files(paths, root=root):
        report.files += 1
        try:
            mod = ModuleSource(rel, abspath.read_text())
        except (SyntaxError, UnicodeDecodeError) as e:
            line = getattr(e, "lineno", 0) or 0
            report.findings.append(Finding(path=rel, line=line,
                                           rule=PARSE_ERROR, message=str(e)))
            continue
        found, dropped = check_module(mod, rules)
        report.findings.extend(found)
        report.suppressed += dropped
    report.findings.sort()
    return report


# ---------------------------------------------------------------- baseline

def load_baseline(path) -> list:
    data = json.loads(Path(path).read_text())
    return [Finding.from_dict(d) for d in data.get("findings", data)]


def write_baseline(path, findings: Sequence[Finding]) -> None:
    payload = {"findings": [f.to_dict() for f in sorted(findings)]}
    Path(path).write_text(json.dumps(payload, indent=1) + "\n")


def split_new(findings: Sequence[Finding],
              baseline: Sequence[Finding]) -> tuple[list, list]:
    """Partition into (new, baselined) by line-insensitive key."""
    accepted = {f.key() for f in baseline}
    new = [f for f in findings if f.key() not in accepted]
    old = [f for f in findings if f.key() in accepted]
    return new, old
