"""Nothing under bench/ imports JAX or the JAX package; the reference, the
yardstick and every architecture import nothing of the program.  Module names are compared by
their whole top-level name (``repro_torch`` is not ``repro``)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("harness/reference.py", "harness/traffic.py", "harness/yardstick.py",
             "harness/weights.py", "harness/check.py")
ARCHITECTURES = sorted((BENCH / "architectures").glob("*.py")) + [BENCH / "tests" / "toy_moe.py"]
ARCHITECTURE_IMPORTS = {"__future__", "math", "numpy", "torch", "bench"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("rel", YARDSTICK)
def test_reference_and_yardstick_import_nothing_of_the_program(rel):
    assert "repro_torch" not in top_level_imports(BENCH / rel)


@pytest.mark.parametrize("path", ARCHITECTURES, ids=lambda p: str(p.relative_to(BENCH)))
def test_an_architecture_imports_torch_numpy_and_the_shared_reference_only(path):
    assert top_level_imports(path) <= ARCHITECTURE_IMPORTS
    tree = ast.parse(path.read_text())
    assert {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
            and n.module.startswith("bench")} <= {"bench.harness.reference"}
    assert not any(isinstance(n, ast.Import) and any(a.name.startswith("bench") for a in n.names)
                   for n in ast.walk(tree))


def test_whole_names_are_compared(monkeypatch):
    from bench.harness import cell
    monkeypatch.setattr(cell.sys, "modules", {"repro_torch.core": None, "numpy": None})
    assert cell.forbidden_modules() == []
    monkeypatch.setattr(cell.sys, "modules", {"repro_torch": None, "repro.core": None,
                                              "jaxlib.xla": None})
    assert cell.forbidden_modules() == ["jaxlib", "repro"]
