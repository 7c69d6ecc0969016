"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py``, not the test helpers it imports
(``tests/torch_checks.py``) and not the port's examples import jax or the
JAX package ``repro``."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")
SOURCES = sorted(
    [os.path.relpath(os.path.join(d, f), ROOT)
     for d, _, files in os.walk(PORT) for f in files if f.endswith(".py")]
    + ["chip_smoke.py", os.path.join("tests", "torch_checks.py"),
       os.path.join("examples", "quickstart_torch.py"),
       os.path.join("examples", "content_delivery_torch.py")])
FORBIDDEN = ("jax", "repro")


def _imports(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_found():
    assert "chip_smoke.py" in SOURCES
    assert os.path.join("tests", "torch_checks.py") in SOURCES
    assert len(SOURCES) > 15


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_serve_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch.runtime.serve, repro_torch.core.convert\n"
            "import repro_torch.kernels.rans_decode\n"
            "import repro_torch.core.encode, repro_torch.kernels.rans_encode\n"
            "import repro_torch.runtime.observability\n"
            "import repro_torch.runtime.faultinject\n"
            "import repro_torch.runtime.metrics\n"
            "import repro_torch.runtime.pipeline\n"
            "print('ok')")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=False)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
