"""No module of the benchmark imports JAX, jaxlib, flax or the JAX
package; top-level names are compared whole (``repro_torch`` is the port,
``repro`` the JAX package)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))


def _imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.module and n.level == 0:
            out.add(n.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not (_imported(path) & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "stats.py", "roofline.py", "content.py"):
        assert not (_imported(BENCH / name) & (FORBIDDEN | {"repro_torch"}))


def test_a_run_loads_no_jax():
    root = BENCH.parent
    code = ("import sys; sys.path[:0] = ['src', '.']; "
            "import bench.run, bench.control, bench.spread, bench.rehearse; "
            "from bench.run import run_cell; "
            "run_cell('rand100.mixed_clients', 3, 0.2, False, device='cpu', "
            "rehearse=True); "
            "print(bench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
