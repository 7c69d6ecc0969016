"""The port's parity tests run in a child pytest process, never in the worker.

The suite runs under pytest-xdist, where one long-lived worker process runs
many test files in turn.  The port's tests load torch beside the JAX
package, and a worker that holds both torch and XLA is a process whose
crash (an XLA compile segfault was seen in one) takes the worker down with
every later test it was given.  So a test decorated with ``in_child`` does
not run its body in the worker: the worker starts one child pytest process
per test file, for the selected tests of that file together, and each test
in the worker reports its child's outcome: a pass, a skip with its reason,
or a failure with the child's report.  The worker never imports torch.  A
child that crashes or runs out of time fails that file's tests with its
output; it cannot hang or kill the worker.

Set ``REPRO_TORCH_TEST_CHILD=1`` to run the bodies in the current process;
the child sets it for itself.

The tests here check that mechanism: every port test carries the decorator,
no port test file loads torch at import, and the child's outcomes (pass,
skip, failure, crash) reach the worker's test.
"""

import ast
import functools
import glob
import inspect
import os
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

import pytest

CHILD_ENV = "REPRO_TORCH_TEST_CHILD"
CHILD_TIMEOUT_S = 600
HERE = os.path.dirname(os.path.abspath(__file__))
# Files whose tests need no torch in-process and so run in the worker.
IN_WORKER = {"test_torch_imports.py", "test_torch_isolation.py"}

_outcomes: dict = {}     # test file -> (outcomes by test name, rc, output)


def in_child_process() -> bool:
    return os.environ.get(CHILD_ENV) == "1"


def in_child(test):
    """Run ``test`` in its file's child pytest process and report the
    outcome here.  In the child the test is returned unchanged."""
    if in_child_process():
        return test
    sig = inspect.signature(test)
    params = [p for p in sig.parameters.values() if p.name != "request"]
    params.append(inspect.Parameter("request", inspect.Parameter.KEYWORD_ONLY))

    @functools.wraps(test)
    def report(*args, request, **kwargs):
        _report(request)

    report.__signature__ = sig.replace(parameters=params)
    return report


def run_child(nodeids, cwd, timeout=CHILD_TIMEOUT_S):
    """Run ``nodeids`` in one child pytest process.  Returns the outcome of
    each test by name (``(kind, text)``, kind one of passed, skipped,
    failed), the child's exit code and the tail of its output."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env[CHILD_ENV] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "child.xml")
        cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
               "-p", "no:xdist", "-p", "no:randomly", f"--junitxml={xml}",
               *nodeids]
        try:
            proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                                  text=True, timeout=timeout, check=False)
            rc, output = proc.returncode, proc.stdout + proc.stderr
        except subprocess.TimeoutExpired as e:
            rc = "timeout"
            output = f"child ran past {timeout} s\n" + (
                e.stdout.decode(errors="replace") if e.stdout else "")
        outcomes = _parse_junit(xml) if os.path.exists(xml) else {}
    return outcomes, rc, output[-4000:]


def _parse_junit(path):
    rank = {"passed": 0, "skipped": 1, "failed": 2}
    out = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        kind, text = "passed", ""
        for child in case:
            if child.tag in ("failure", "error"):
                kind = "failed"
                text = (child.get("message") or "") + "\n" + (child.text or "")
            elif child.tag == "skipped" and kind == "passed":
                kind, text = "skipped", child.get("message") or ""
        name = case.get("name")
        if name not in out or rank[kind] > rank[out[name][0]]:
            out[name] = (kind, text)
    return out


def _report(request):
    path = str(request.node.path)
    if path not in _outcomes:
        nodeids = [item.nodeid for item in request.session.items
                   if str(item.path) == path]
        _outcomes[path] = run_child(nodeids, str(request.config.rootpath))
    outcomes, rc, output = _outcomes[path]
    kind, text = outcomes.get(request.node.name, (None, None))
    if kind == "passed":
        return
    if kind == "skipped":
        pytest.skip(text)
    if kind == "failed":
        pytest.fail(f"in the child pytest process:\n{text}", pytrace=False)
    pytest.fail(f"the child pytest process (exit {rc}) did not report "
                f"{request.node.name}:\n{output}", pytrace=False)


# ---------------------------------------------------------------------------
# Checks of the mechanism
# ---------------------------------------------------------------------------

PORT_TEST_FILES = sorted(
    p for p in glob.glob(os.path.join(HERE, "test_torch_*.py"))
    if os.path.basename(p) not in IN_WORKER)


def _decorator_names(fn):
    for d in fn.decorator_list:
        yield ast.unparse(d)


@pytest.mark.parametrize("path", PORT_TEST_FILES, ids=os.path.basename)
def test_port_tests_run_in_children(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    tests = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    assert tests
    for fn in tests:
        assert "in_child" in _decorator_names(fn), f"{fn.name} runs in the worker"
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module])
            assert not [m for m in mods
                        if m.split(".")[0] in ("torch", "repro_torch")], \
                f"{os.path.basename(path)} imports torch at collection"


def test_worker_has_not_loaded_torch():
    assert in_child_process() or "torch" not in sys.modules


def test_child_outcomes_reach_the_worker(tmp_path):
    body = ("import os, pytest\n"
            "def test_ok(): pass\n"
            "def test_skips(): pytest.skip('no card here')\n"
            "def test_fails(): assert 1 == 2, 'wrong sum'\n"
            "def test_sees_child_env():\n"
            f"    assert os.environ['{CHILD_ENV}'] == '1'\n")
    (tmp_path / "test_demo.py").write_text(body)
    outcomes, rc, _ = run_child(["test_demo.py"], str(tmp_path), timeout=120)
    assert rc == 1
    assert outcomes["test_ok"] == ("passed", "")
    assert outcomes["test_sees_child_env"] == ("passed", "")
    assert outcomes["test_skips"][0] == "skipped"
    assert "no card here" in outcomes["test_skips"][1]
    assert outcomes["test_fails"][0] == "failed"
    assert "wrong sum" in outcomes["test_fails"][1]


def test_child_crash_fails_without_outcomes(tmp_path):
    (tmp_path / "test_crash.py").write_text(
        "import os\ndef test_dies(): os._exit(3)\n")
    outcomes, rc, _ = run_child(["test_crash.py"], str(tmp_path), timeout=120)
    assert outcomes == {} and rc == 3
