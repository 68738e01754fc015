"""The port's invariant linter (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

* Every good and bad snippet of ``tests/test_analysis.py`` (its fixture
  constants and the sources its tests build inline) goes through both
  ``check_source``s, at the reference's paths under ``src/repro/`` and the
  same paths under ``src/repro_torch/`` (and at ``tests/`` and
  ``benchmarks/`` paths for both): the same findings, rule, line and
  message.
* The port's tree, its tests and ``chip_smoke.py`` lint clean.
* The port's CLI gives the reference's exit codes and JSON on a tmp tree.
"""
from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import ALL_RULES as J_RULES
from repro.analysis import check_source as j_check
from repro.analysis.__main__ import main as j_main
from repro_torch.analysis import ALL_RULES as T_RULES
from repro_torch.analysis import check_source as t_check
from repro_torch.analysis import run_paths as t_run_paths
from repro_torch.analysis.__main__ import main as t_main

REPO = Path(__file__).resolve().parent.parent

# (the reference's path, the port's) of every path tests/test_analysis.py
# lints a snippet at: the src scope, its serving and oracle layers, a
# re-export module, and the two trees outside the src scope
PATHS = [("src/repro/fixture.py", "src/repro_torch/fixture.py"),
         ("src/repro/serving/fixture.py", "src/repro_torch/serving/fixture.py"),
         ("src/repro/core/oracles/fixture.py", "src/repro_torch/core/oracles/fixture.py"),
         ("src/repro/core/executor_fixture.py", "src/repro_torch/core/executor_fixture.py"),
         ("src/repro/sub/__init__.py", "src/repro_torch/sub/__init__.py"),
         ("tests/fixture.py", "tests/fixture.py"),
         ("benchmarks/fixture.py", "benchmarks/fixture.py")]


def _snippets() -> dict:
    """Every source string of ``tests/test_analysis.py`` that parses as
    Python once dedented: its module-level fixtures by name, the strings
    its test functions build inline by ``function:line`` (docstrings
    left out)."""
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef)) and n.body
            and isinstance(n.body[0], ast.Expr)}
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            out[node.targets[0].id] = node.value.value
        elif isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                        and "\n" in sub.value and id(sub) not in docs):
                    out[f"{node.name}:{sub.lineno}"] = sub.value
    good = {}
    for name, src in out.items():
        try:
            ast.parse(textwrap.dedent(src))
        except SyntaxError:
            continue
        good[name] = textwrap.dedent(src)
    return good


SNIPPETS = _snippets()


def _plain(findings) -> list:
    return [(f.rule, f.line, f.message) for f in findings]


def test_snippets_cover_every_fixture():
    names = [n for n in SNIPPETS if ":" not in n]
    assert len([n for n in names if n.startswith("BAD_")]) >= 15
    assert len([n for n in names if n.startswith("GOOD_")]) >= 10
    assert any(":" in n for n in SNIPPETS)          # inline sources too
    assert len(SNIPPETS) >= 40


def test_same_rule_catalog():
    assert [r.id for r in T_RULES] == [r.id for r in J_RULES]
    assert all(r.summary for r in T_RULES)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_findings_equal_reference(name):
    src = SNIPPETS[name]
    hit = False
    for jpath, tpath in PATHS:
        want = j_check(src, jpath)
        got = t_check(src, tpath)
        assert _plain(got) == _plain(want), (jpath, _plain(got), _plain(want))
        assert all(f.path == tpath for f in got)
        hit |= bool(want)
    if name.startswith("BAD_"):
        assert hit, f"{name} flags nothing at any path"


def test_src_rules_scoped_to_the_port():
    """The rules the reference scopes to ``src/repro/`` apply to
    ``src/repro_torch/`` in the port and to nothing else, the reference's
    own tree included."""
    bad = SNIPPETS["BAD_HASH"]
    assert {f.rule for f in t_check(bad, "src/repro_torch/x.py")} == {"determinism"}
    assert t_check(bad, "src/repro/x.py") == []
    assert {f.rule for f in j_check(bad, "src/repro/x.py")} == {"determinism"}
    assert j_check(bad, "src/repro_torch/x.py") == []
    charge = SNIPPETS["BAD_CHARGE"]
    assert t_check(charge, "src/repro_torch/core/oracles/x.py") == []
    assert {f.rule for f in t_check(charge, "src/repro_torch/serving/x.py")} \
        == {"ledger-discipline"}


def test_port_tree_is_clean():
    """The gate for the port: its package, the tests and the smoke script
    lint clean (the six kv-pairing sites whose ownership moves to a caller
    carry the reference's suppression)."""
    report = t_run_paths(["src/repro_torch", "tests", "chip_smoke.py"], root=REPO)
    assert report.files > 100
    assert report.findings == [], "\n".join(str(f) for f in report.findings)
    assert report.suppressed == 6


def _tree(tmp_path, pkg: str, files: dict) -> Path:
    root = tmp_path / pkg.replace("/", "_")
    d = root / "src" / pkg
    d.mkdir(parents=True)
    for name, text in files.items():
        (d / name).write_text(text)
    return root


def _run(main, root: Path, pkg: str, *extra) -> tuple:
    out = root / "report.json"
    rc = main([str(root / "src" / pkg), "--json", str(out), *extra])
    payload = json.loads(out.read_text())

    def strip(fs):
        return [(Path(f["path"]).name, f["line"], f["rule"], f["message"]) for f in fs]

    return rc, {k: (strip(v) if k in ("new", "findings") else v) for k, v in payload.items()}


@pytest.mark.parametrize("files", [
    {"dirty.py": "def f(k):\n    return hash(k)\n"},
    {"dirty.py": "def f(k):\n    return k\n"},
    {"a.py": "import os\nimport random\nr = random.random()\n",
     "b.py": "def admit(self):\n    self.pool.incref(self.blocks)\n"},
    {"broken.py": "def broken(:\n"},
], ids=["hash", "clean", "three_rules", "parse_error"])
def test_cli_exit_codes_and_json_equal_reference(tmp_path, capsys, files):
    jroot = _tree(tmp_path, "repro", files)
    troot = _tree(tmp_path, "repro_torch", files)
    want = _run(j_main, jroot, "repro")
    got = _run(t_main, troot, "repro_torch")
    capsys.readouterr()
    assert got[0] == want[0]
    for key in ("files", "suppressed", "baselined", "new", "findings"):
        assert got[1][key] == want[1][key], key
    assert {k: v.replace("src/repro_torch/", "src/repro/") for k, v in got[1]["rules"].items()} \
        == want[1]["rules"]


def test_cli_baseline_and_usage_equal_reference(tmp_path, capsys):
    for main, pkg in ((j_main, "repro"), (t_main, "repro_torch")):
        root = _tree(tmp_path, pkg, {"dirty.py": "def f(k):\n    return hash(k)\n"})
        target, base = str(root / "src" / pkg), str(root / "baseline.json")
        assert main([target, "--baseline", base, "--write-baseline"]) == 0
        assert main([target, "--baseline", base]) == 0
        (root / "src" / pkg / "worse.py").write_text("import random\nr = random.random()\n")
        assert main([target, "--baseline", base]) == 1
        assert main([]) == 2
        assert main(["--write-baseline", target]) == 2
        assert main(["--rules"]) == 0
        text = capsys.readouterr().out
        assert "kv-pairing" in text and "determinism" in text


def test_cli_runs_without_jax_or_torch(tmp_path):
    """``python -m repro_torch.analysis`` imports neither JAX nor PyTorch:
    the linter is stdlib only."""
    code = ("import sys, runpy; sys.argv = ['x', 'src/repro_torch/analysis'];\n"
            "try:\n    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "print(rc, sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stdout
