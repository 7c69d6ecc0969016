"""On the card: each cell runs at its full size and is correct, and its
control at the cell's own size is not.  Skipped without a card; run them
on the chip with ``python -m pytest -q -m cuda bench/tests``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench import manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _script(*args):
    return subprocess.run([sys.executable, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    out = _script("bench/run.py", "--workload", cell, "--seed",
                  str(2 ** 31 + 123), "--seconds", "2", "--trace", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    out = _script("bench/control.py", "--workload", cell, "--seeds",
                  str(2 ** 31 + 321))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
