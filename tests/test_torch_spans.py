"""The port's ranges on the profiler's clock (``repro_torch.spans``), on the
CPU: free while no profiler records, nested ``recoil.*`` ranges through
``DecodeService.decode`` and a chunked decode under a CPU-only
``torch.profiler``, and the collector's pauses as ``recoil.gc``.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and torch is imported inside the tests, so the test worker never loads it.
"""

import gc

import numpy as np
from test_torch_isolation import in_child

CHAIN = ("recoil.decode", "recoil.execute", "recoil.walk.launch")


def _service():
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.runtime.serve import DecodeService
    s = np.minimum(np.random.default_rng(5).exponential(35.0, 6000)
                   .astype(np.int64), 255)
    m = StaticModel.from_symbols(s, 256, RansParams(n_bits=11, ways=32))
    svc = DecodeService(m, device="cpu")
    svc.ingest("c", s, 16)
    return svc, s


def _profile(fn):
    """``fn()`` under a CPU-only profiler; returns its result and the
    host-side ``recoil.*`` ranges as (start, end, name, thread), by start."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    ranges = sorted((ev.time_range.start, ev.time_range.end, ev.name,
                     ev.thread) for ev in prof.events()
                    if ev.name.startswith("recoil."))
    return out, ranges


@in_child
def test_span_is_the_shared_noop_without_a_profiler(monkeypatch):
    import torch
    from repro_torch import spans
    from repro_torch.runtime import observability

    def built(name):
        raise AssertionError(f"a range {name!r} built")

    monkeypatch.setattr(spans, "_RANGE", built)
    monkeypatch.setattr(torch.profiler, "record_function", built)
    for name in CHAIN + ("recoil.walk.alloc",):
        assert spans.span(name) is spans.NULL_SPAN
    with spans.span("recoil.decode") as inside:
        assert inside is None
    assert observability.span is spans.span
    svc, s = _service()          # the decode path opens no range either
    assert (svc.decode("c", 8).numpy() == s).all()


@in_child
def test_decode_spans_nest_on_one_thread_and_leave_outputs_equal():
    svc, s = _service()
    plain = svc.decode("c", 8)
    assert (plain.numpy() == s).all()
    outs, ranges = _profile(lambda: [svc.decode("c", 8),
                                     svc.decode("c", 8)])
    for out in outs:
        assert np.array_equal(out.numpy(), plain.numpy())
    ranges = [r for r in ranges if r[2] != "recoil.gc"]
    assert [r[2] for r in ranges] == list(CHAIN) * 2
    assert len({r[3] for r in ranges}) == 1
    for call in (ranges[:3], ranges[3:]):
        for outer, inner in zip(call, call[1:]):
            assert outer[0] <= inner[0] and inner[1] <= outer[1]
    assert ranges[2][1] <= ranges[3][0]          # the calls do not overlap


@in_child
def test_each_chunk_launch_gets_its_execute_span():
    svc, s = _service()
    want = svc.decode_chunks("c", 16, 4)
    assert np.array_equal(np.concatenate([c.numpy() for c in want]), s)
    got, ranges = _profile(lambda: svc.decode_chunks("c", 16, 4))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b.numpy())
    names = [r[2] for r in ranges if r[2] != "recoil.gc"]
    assert names == ["recoil.execute", "recoil.walk.launch"] * len(want)


@in_child
def test_collector_pause_is_a_gc_range_only_while_profiling():
    from repro_torch import spans
    _service()
    _service()                   # a second Observability: still one hook
    assert sum(cb is spans._GC_HOOK for cb in gc.callbacks) == 1
    gc.collect()                 # no profiler: nothing opened or left open
    assert spans._GC_HOOK.open is None
    _, ranges = _profile(gc.collect)
    pauses = [r for r in ranges if r[2] == spans.GC_SPAN]
    assert len(pauses) == 1 and pauses[0][0] <= pauses[0][1]
    assert spans._GC_HOOK.open is None
