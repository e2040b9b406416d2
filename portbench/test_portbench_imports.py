"""Nothing under portbench/ imports JAX or the JAX package (``repro``),
compared by whole top-level names (``repro_torch`` begins with ``repro``);
the reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & FORBIDDEN


def test_whole_names_compared():
    from portbench import harness
    assert "repro_torch".split(".")[0] not in harness.FORBIDDEN
    assert "repro.core".split(".")[0] in harness.FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]; import portbench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & (FORBIDDEN | {"repro_torch"})
    src = {n.split(".")[0] for n in imported(HERE / "reference.py")}
    assert src <= {"__future__", "typing", "torch"}
