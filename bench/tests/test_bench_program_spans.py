"""The reduction of the program's ``recoil.*`` ranges (``program_spans.py``)
on interval tuples, and on the card each cell's traced run with it."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import manifest, program_spans, tracing

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in manifest.manifest()["workloads"]]

# Device operations, window [0, 100]: busy 10-20 and 30-70, so idle
# 0-10, 20-30 and 70-100 (50 in all).
DEV = [(10, 20), (30, 60), (55, 70)]
# Two calls on thread 1; a pause inside the first call's launch and one on
# thread 2 across the second call's end.
RANGES = [
    (5, 40, "recoil.decode", 1), (8, 38, "recoil.execute", 1),
    (12, 36, "recoil.walk.launch", 1), (14, 16, "recoil.walk.alloc", 1),
    (25, 28, "recoil.gc", 1),
    (65, 95, "recoil.decode", 1), (67, 90, "recoil.execute", 1),
    (68, 85, "recoil.walk.launch", 1), (70, 71, "recoil.walk.alloc", 1),
    (80, 99, "recoil.gc", 2),
]


def test_self_times_subtract_direct_children_on_the_same_thread():
    red = program_spans.reduce(DEV, 0, 100, RANGES)
    assert red["spans"] == {
        "recoil.decode": {"count": 2, "total_us": 65, "self_us": 12},
        "recoil.execute": {"count": 2, "total_us": 53, "self_us": 12},
        "recoil.walk.launch": {"count": 2, "total_us": 41, "self_us": 35},
        "recoil.walk.alloc": {"count": 2, "total_us": 3, "self_us": 3},
        "recoil.gc": {"count": 2, "total_us": 22, "self_us": 22},
    }
    m = program_spans.metrics(red)
    assert m["service_self_us.decode"] == 6
    assert m["engine_self_us.decode"] == 6
    assert m["launch_self_us.decode"] == 17.5
    assert m["alloc_us.decode"] == 1.5
    # The four sum to the mean call less the pause inside it.
    assert sum(m[k] for k in program_spans.HOST_METRICS) == 32.5 - 1.5


def test_idle_shares_never_count_the_same_time_twice():
    red = program_spans.reduce(DEV, 0, 100, RANGES)
    assert red["idle_s"] == pytest.approx(50e-6)
    # Under the collector: 25-28 and 80-99.  Under a call and not the
    # collector: 5-10, 20-25, 28-30, 70-80 and 95-99 less 95-99's pause.
    assert red["idle_in_gc_s"] == pytest.approx(22e-6)
    assert red["idle_in_program_s"] == pytest.approx(22e-6)
    m = program_spans.metrics(red)
    assert m["idle_in_gc_pct.decode"] == pytest.approx(44.0)
    assert m["idle_in_program_pct.decode"] == pytest.approx(44.0)


def test_gaps_are_labelled_by_the_innermost_open_range():
    red = program_spans.reduce(DEV, 0, 100, RANGES)
    got = [[n, pytest.approx(s)] for n, s in red["idle_gaps_program"]]
    assert got == [["recoil.gc", 30e-6], ["recoil.decode", 10e-6],
                   ["recoil.gc", 10e-6]]
    red = program_spans.reduce(DEV, 0, 100, RANGES[:4])
    assert red["idle_gaps_program"][0][0] == program_spans.NO_SPAN


def test_idle_under_the_profilers_own_events_is_not_the_programs():
    """CUPTI's buffer request at 0-9 covers most of the first gap, 5-9 of
    it inside the first call: that gap is the profiler's, and the
    program's share loses those 4."""
    red = program_spans.reduce(DEV, 0, 100, RANGES, [(0, 9)])
    assert red["idle_in_profiler_s"] == pytest.approx(9e-6)
    assert red["idle_in_program_s"] == pytest.approx(18e-6)
    assert red["idle_in_gc_s"] == pytest.approx(22e-6)
    assert [n for n, _ in red["idle_gaps_program"]] == [
        "recoil.gc", program_spans.PROFILER, "recoil.gc"]
    m = program_spans.metrics(red)
    assert m["idle_in_program_pct.decode"] == pytest.approx(36.0)
    assert red["spans"] == program_spans.reduce(DEV, 0, 100,
                                                RANGES)["spans"]


def test_nothing_to_read_gives_none():
    assert program_spans.reduce([], 0, 100, RANGES) is None
    assert program_spans.reduce(DEV, 0, 100, []) is None
    no_call = [r for r in RANGES if r[2] != "recoil.decode"]
    assert program_spans.reduce(DEV, 0, 100, no_call) is None
    assert program_spans.metrics(None) == {}
    red = program_spans.reduce(DEV, 10, 70, RANGES[:1] + [(20, 30, "x", 1)])
    assert "idle_in_gc_pct.decode" in program_spans.metrics(red)
    busy = program_spans.reduce([(0, 100)], 0, 100, RANGES)
    assert "idle_in_gc_pct.decode" not in program_spans.metrics(busy)


def _ev(name, a, b, card=False, thread=1, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=a, end=b), thread=thread,
        device_type="DeviceType.CUDA" if card else "DeviceType.CPU",
        is_user_annotation=annotation)


def test_trace_feeds_the_reduction_as_summarize_reads_it():
    """A ``bench.`` span's shadow on the device's timeline is no
    operation, for the reduction and for ``summarize`` alike; the window
    is summarize's; the profiler's own events reach the reduction."""
    events = [_ev("bench.window", 0, 100, annotation=True),
              _ev("bench.window", 1, 100, card=True, annotation=True),
              _ev("Activity Buffer Request", 0, 9, thread=3)]
    events += [_ev("walk_pointer_kernel", a, b, card=True) for a, b in DEV]
    events += [_ev(name, a, b, thread=thread)
               for a, b, name, thread in RANGES]
    prof = SimpleNamespace(events=lambda: events)
    assert program_spans.from_trace(prof) == \
        program_spans.reduce(DEV, 0, 100, RANGES, [(0, 9)])
    s = tracing.summarize(prof)
    assert list(s.device_s) == ["walk_pointer_kernel"]
    assert s.busy_s == pytest.approx(50e-6)
    assert program_spans.from_trace(SimpleNamespace(events=lambda: [])) \
        is None


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_reads_the_program_spans_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "bench/program_spans.py", "--workload", cell,
         "--seed", str(2 ** 31 + 99), "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    m = res["program"]["metrics"]
    assert set(m) == set(program_spans.HOST_METRICS) | {
        "idle_in_program_pct.decode", "idle_in_gc_pct.decode"}
    assert m["idle_in_program_pct.decode"] + m["idle_in_gc_pct.decode"] \
        <= 100.0
    host = sum(m[k] for k in program_spans.HOST_METRICS)
    assert host >= 0.85 * res["metrics"]["enqueue_us.decode"]["value"]
    assert not any(n.startswith("recoil.")
                   for n, _ in res["breakdown"]["device_ops"])
    assert res["breakdown"]["idle_gaps_program"]
