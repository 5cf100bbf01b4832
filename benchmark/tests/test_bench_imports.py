"""What the benchmark may import: never JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and in the plain references nothing of the port."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "langscenex_tpu"}
PORT = "langscenex_tpu_torch"


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def benchmark_imports(path: Path) -> set:
    """The benchmark modules that ``path`` imports."""
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("benchmark"):
            mods.add(node.module)
        elif isinstance(node, ast.ImportFrom) and node.level:
            mods.add((path.parent.name, node.module))
    return mods


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & FORBIDDEN


def test_top_level_names_are_compared_whole():
    from benchmark import run
    import sys
    sys.modules["langscenex_tpu_torch_probe"] = object()
    try:
        assert "langscenex_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["langscenex_tpu_torch_probe"]


def reference_closure() -> list:
    """The reference modules and the benchmark modules they import."""
    seen, todo = [], sorted((BENCH / "reference").glob("*.py"))
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.append(p)
        for mod in benchmark_imports(p):
            if isinstance(mod, tuple):
                target = BENCH / mod[0] / f"{mod[1]}.py"
            else:
                target = BENCH.parent / (mod.replace(".", "/") + ".py")
            if target.exists():
                todo.append(target)
    return seen


def test_references_import_nothing_of_the_port():
    closure = reference_closure()
    assert any(p.name == "field_semantic.py" for p in closure)
    for p in closure:
        assert PORT not in imported_tops(p), p
