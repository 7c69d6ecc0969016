"""A run of each cell on the CPU, at its rehearsal sizes, with the timed
path broken underneath: ``correct`` must come out false for every fault
the cell can have, true for the sound program, and false for the control
on three seeds."""

import pytest

from bench.run import run_cell

SEED = 2 ** 31 + 17


def _run(cell, seed=SEED, **kw):
    return run_cell(cell, seed, 1.0, False, device="cpu", rehearse=True,
                    **kw)


def answer_altered(monkeypatch):
    """Every decode's output has symbols changed where it is produced."""
    from repro_torch.core.engine.session import DecoderSession
    orig = DecoderSession.execute

    def execute(self, plan):
        out = orig(self, plan)
        out[::997] ^= 1
        return out
    monkeypatch.setattr(DecoderSession, "execute", execute)


FAULTS = [
    ("rand100.cpu_client", answer_altered),
    ("rand100.mixed_clients", answer_altered),
]
CELLS = sorted({c for c, _ in FAULTS})


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    for seed in (SEED + 1, SEED + 2, SEED + 3):
        res = _run(cell, seed=seed, control=True)
        assert not res["correct"], (seed, res["checks"])
