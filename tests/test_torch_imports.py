"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` or ``chip_holds.py``, not the test helpers it imports
(``tests/torch_checks.py``) and not the port's examples import jax, the
JAX package ``repro`` or ``ml_dtypes`` (the card machine has none of
them)."""

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
    + ["chip_smoke.py", "chip_holds.py",
       os.path.join("tests", "torch_checks.py"),
       os.path.join("examples", "quickstart_torch.py"),
       os.path.join("examples", "content_delivery_torch.py"),
       os.path.join("examples", "train_lm_torch.py"),
       os.path.join("examples", "checkpoint_distribution_torch.py")])
FORBIDDEN = ("jax", "repro", "ml_dtypes")


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
            "sys.modules['ml_dtypes'] = None\n"
            "import repro_torch.runtime.serve, repro_torch.core.convert\n"
            "import repro_torch.kernels.rans_decode\n"
            "import repro_torch.core.encode, repro_torch.kernels.rans_encode\n"
            "import repro_torch.runtime.observability\n"
            "import repro_torch.runtime.faultinject\n"
            "import repro_torch.runtime.metrics\n"
            "import repro_torch.runtime.pipeline\n"
            "import repro_torch.configs, repro_torch.models.model\n"
            "import repro_torch.models.moe, repro_torch.models.ssm\n"
            "import repro_torch.models.convert, repro_torch.optim.compress\n"
            "import repro_torch.checkpoint.manager\n"
            "from repro_torch.configs import ARCH_IDS, get_config\n"
            "[get_config(a) for a in ARCH_IDS]\n"
            "print('ok')")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=False)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_training_imports_with_jax_blocked():
    """The training side (``optim``, ``runtime.train``, ``runtime.fault``,
    ``data``, the pod mesh) and the two training examples import with jax,
    the JAX package and ``ml_dtypes`` blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'repro', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.optim.adamw, repro_torch.optim.schedule\n"
            "import repro_torch.optim.compress, repro_torch.runtime.train\n"
            "import repro_torch.runtime.fault, repro_torch.data.pipeline\n"
            "import repro_torch.data, repro_torch.launch.mesh\n"
            "import importlib.util, os\n"
            "for name in ('train_lm_torch',\n"
            "             'checkpoint_distribution_torch'):\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        name, os.path.join('examples', name + '.py'))\n"
            "    module = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(module)\n"
            "print('ok')")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=False,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_sharding_and_dry_run_with_jax_blocked(tmp_path):
    """The sharding rules, the roofline and the dry run import with jax,
    the JAX package and ``ml_dtypes`` blocked, and the dry run's CLI costs
    a cell on the CPU."""
    code = ("import sys\n"
            "for m in ('jax', 'repro', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.parallel.sharding, repro_torch.launch\n"
            "import repro_torch.launch.roofline\n"
            "from repro_torch.launch import dryrun\n"
            f"dryrun.main(['--arch', 'mamba2_2_7b', '--shape', 'decode_32k',"
            f" '--mesh', 'card', '--out', {str(tmp_path)!r}])\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=False,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ALL CELLS PASSED" in out.stdout
    assert os.path.exists(os.path.join(
        tmp_path, "card", "mamba2_2_7b__decode_32k.json"))
