"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program. Modules are compared by
their top-level name, whole: the port's name begins with the JAX
package's."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

BENCH = harness.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "bloomscene_tpu"}


def imported_top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_imports(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_top_names(path) & (FORBIDDEN
                                           | {"bloomscene_tpu_torch"})


def test_loaded_modules():
    """What importing the harness and the reference loads, in a fresh
    interpreter: no JAX, and the reference alone loads no program."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.reference.step, perfbench.counts\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'bloomscene_tpu',"
        " 'bloomscene_tpu_torch'}))\n"
        "import perfbench.harness, perfbench.tracing, perfbench.readers\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'bloomscene_tpu'}))\n"
    ) % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.split("\n")[:2] == ["[]", "[]"]


def test_forbidden_names_compare_whole(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bloomscene_tpu_torch_probe", object())
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.probe", object())
    assert "jaxlib" in harness.forbidden_modules()
