"""``walk_overlap.decode`` read from a synthetic trace summary: the walk
kernels' summed time over the device's busy time, and nothing without a
trace or busy time."""

import types

import pytest

from bench import manifest
from bench.tracing import Summary


def _run(busy_s, device_s):
    trace = Summary(window_s=10.0, busy_s=busy_s, device_s=device_s,
                    top_ops=[], idle_gaps=[])
    return types.SimpleNamespace(trace=trace)


@pytest.mark.parametrize("busy_s,device_s,want", [
    # Walks one after another: their time is the busy time.
    (9.8, {"walk_pointer_kernel<true, 32, 128>": 9.8}, 1.0),
    # Four walks side by side, a copy beside them, both layouts counted.
    (2.5, {"walk_pointer_kernel<true, 32, 128>": 6.0,
           "walk_symbol_kernel<32, 128>": 3.0, "Memcpy HtoD": 0.5}, 3.6),
])
def test_reads_walk_time_over_busy_time(busy_s, device_s, want):
    r = manifest.reader("walk_overlap.decode")
    assert r.read(_run(busy_s, device_s)) == pytest.approx(want)


def test_reads_nothing_without_a_trace_or_busy_time():
    r = manifest.reader("walk_overlap.decode")
    assert r.read(types.SimpleNamespace(trace=None)) is None
    assert r.read(_run(0.0, {})) is None
