"""The engine's stream pool on the card: the walks of independent requests
run side by side on the ``cuda`` executor's streams, and what they return
equals the same plans run one at a time.

Marked ``cuda``: each test takes the ``cuda_device`` fixture, which skips
when no CUDA device is present (decided inside the fixture, never while the
module is imported).  Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_walk_pool.py

Content is made from a seed with numpy (``rand_100``'s exponential bytes)
and ingested on the card at 2176 splits; clients thin it to 16, 128 and
2176 threads.  Each test runs in a child pytest process
(``test_torch_isolation.in_child``), and torch and the port are imported
inside the fixtures and tests, so the test worker never loads torch.
"""

import numpy as np
import pytest
from test_torch_isolation import in_child, in_child_process

pytestmark = pytest.mark.cuda

THREADS = (16, 128, 2176)
N_SYMBOLS = 1 << 23          # a 16-split walk of about 2.3 ms on the H100
N_ASSETS = 4


@pytest.fixture(scope="module")
def cuda_device():
    if not in_child_process():
        return None     # the worker only reports the child's outcome
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.rans_decode.rans_decode import load_library
    load_library()
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def catalog(cuda_device):
    """``N_ASSETS`` contents of ``N_SYMBOLS`` bytes and their model."""
    if cuda_device is None:
        return None
    from repro_torch.core.rans import RansParams, StaticModel
    rng = np.random.default_rng(30)
    syms = [np.minimum(rng.exponential(25.5, N_SYMBOLS), 255).astype(np.int64)
            for _ in range(N_ASSETS)]
    model = StaticModel.from_symbols(np.concatenate(syms + [np.arange(256)]),
                                     256, RansParams(n_bits=11, ways=32))
    return model, syms


def _service(device, catalog, layout="pointer"):
    """A service holding the catalog as ``a0``, ``a1``, ...; returns it and
    each content's symbols on the card."""
    import torch
    from repro_torch.runtime.serve import DecodeService
    model, syms = catalog
    svc = DecodeService(model, device=device, layout=layout)
    want = {}
    for i, s in enumerate(syms):
        svc.ingest(f"a{i}", s, 2176)
        want[f"a{i}"] = torch.as_tensor(s.astype(np.int32), device=device)
    return svc, want


def _calls(svc, names):
    """Every path through ``DecoderSession.execute`` a client takes, at each
    thread count: ``decode`` of each content, ``decode_chunks`` in three
    chunks and a fused group of every content."""
    import torch

    def group(threads):
        tickets = [svc.submit(nm, threads) for nm in names]
        svc.flush()
        return torch.cat([t.result() for t in tickets])

    calls = []
    for t in THREADS:
        calls += [lambda nm=nm, t=t: svc.decode(nm, t) for nm in names]
        calls.append(lambda t=t: torch.cat(svc.decode_chunks(names[0], t, 3)))
        calls.append(lambda t=t: group(t))
    return calls


@pytest.mark.parametrize("layout", ["pointer", "symbol"])
@in_child
def test_pooled_walks_equal_the_plans_run_one_at_a_time(cuda_device, catalog,
                                                        layout):
    """The same calls, once with a device synchronize after each walk (so
    each runs alone, on the caller's stream) and once back to back:
    bit-equal outputs, equal to the content, and only the second run puts
    walks on the pool's streams."""
    import torch
    from repro_torch.core.engine import WALK_STREAMS
    svc, want = _service(cuda_device, catalog, layout)
    assert len(svc.session.executor.streams) == WALK_STREAMS == 4
    names = list(want)[:3]
    expect = []
    for t in THREADS:
        expect += [want[nm] for nm in names]
        expect += [want[names[0]], torch.cat([want[nm] for nm in names])]
    execute = svc.session.execute

    def one_at_a_time(plan):
        out = execute(plan)
        torch.cuda.synchronize()
        return out

    svc.session.execute = one_at_a_time
    before = svc.stats
    alone = [f() for f in _calls(svc, names)]
    mid = svc.stats
    svc.session.execute = execute
    pooled = [f() for f in _calls(svc, names)]
    torch.cuda.synchronize()
    after = svc.stats
    assert mid.overlapped_launches == before.overlapped_launches
    assert after.decodes - mid.decodes == \
        mid.decodes - before.decodes > len(alone)
    assert after.overlapped_launches > mid.overlapped_launches
    assert svc.session.stats.overlapped_launches == after.overlapped_launches
    for a, p, w in zip(alone, pooled, expect):
        assert torch.equal(a, w) and torch.equal(p, w)


@in_child
def test_the_callers_stream_alone_covers_the_output(cuda_device, catalog):
    """After ``decode``, a synchronize of the caller's stream and nothing
    else leaves every pool stream idle; the outputs, read on a stream that
    waits for nothing, are whole."""
    import torch
    svc, want = _service(cuda_device, catalog)
    side = torch.cuda.Stream(cuda_device)
    for _ in range(3):
        outs = {nm: svc.decode(nm, 16) for nm in want}
        torch.cuda.current_stream(cuda_device).synchronize()
        assert all(s.query() for s in svc.session.executor.streams)
        with torch.cuda.stream(side):
            got = {nm: out.to("cpu") for nm, out in outs.items()}
        for nm, out in got.items():
            assert torch.equal(out, want[nm].cpu())
    assert svc.stats.overlapped_launches > 0


@in_child
def test_back_to_back_decodes_survive_allocator_reuse(cuda_device, catalog):
    """200 decodes with no synchronize between them, each output dropped,
    kept, or copied on the caller's stream and then dropped, at random: the
    pool streams reuse the dropped outputs' blocks, and every kept output
    and copy is bit-exact."""
    import torch
    svc, want = _service(cuda_device, catalog)
    rng = np.random.default_rng(200)
    names = list(want)
    kept = []
    for _ in range(200):
        nm = names[rng.integers(len(names))]
        out = svc.decode(nm, int(THREADS[rng.integers(len(THREADS))]))
        action = rng.integers(3)
        if action == 1:
            kept.append((nm, out))
        elif action == 2:
            kept.append((nm, out.clone()))
        del out
    torch.cuda.synchronize()
    assert len(kept) > 50
    for nm, out in kept:
        assert torch.equal(out, want[nm])
    assert svc.stats.overlapped_launches > 100


def _event_ms(run, sleep: bool) -> float:
    """CUDA-event time of ``run()``; with ``sleep`` the events are queued
    behind a device sleep, so that they bracket device time alone."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if sleep:
        torch.cuda._sleep(10_000_000)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


@in_child
def test_walks_behind_a_sleep_stay_inside_its_events(cuda_device, catalog):
    """``execute`` called ten times behind one device sleep, between two
    events, as ``chip_smoke.py::cuda_ms`` times it: the first walk runs on
    the caller's stream behind the sleep, and the nine on the pool wait for
    the event recorded before it, so none runs during the sleep.  The five
    streams (the caller's and the pool's) hold ten walks, so the events
    bracket at least two walks' time; walks escaping into the sleep would
    leave about one."""
    import torch
    from repro_torch.core.engine import WALK_STREAMS
    svc, want = _service(cuda_device, catalog)
    sess = svc.session
    plan = svc.prepare_request("a0", 16)
    svc.decode("a0", 16)
    one = np.median([_event_ms(lambda: sess.execute(plan), True)
                     for _ in range(3)])
    n = 10
    outs = []
    over = svc.stats.overlapped_launches
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    e0.record()
    for _ in range(n):
        outs.append(sess.execute(plan))
    e1.record()
    torch.cuda.synchronize()
    assert svc.stats.overlapped_launches - over == n - 1
    assert e0.elapsed_time(e1) >= n / (WALK_STREAMS + 1) * one, \
        (e0.elapsed_time(e1), one)
    for out in outs:
        assert torch.equal(out, want["a0"])


@in_child
def test_four_16_split_decodes_run_side_by_side(cuda_device, catalog):
    """Four 16-split decodes of distinct contents, host enqueue included,
    take under 1.6 times one decode's device time (one after another they
    take four times)."""
    svc, want = _service(cuda_device, catalog)
    names = list(want)
    for nm in names:
        svc.decode(nm, 16)      # plans and launchers made
    one = np.median([_event_ms(lambda: svc.decode(names[0], 16), True)
                     for _ in range(5)])
    four = np.median([_event_ms(lambda: [svc.decode(nm, 16) for nm in names],
                                False) for _ in range(5)])
    assert four < 1.6 * one, (four, one)


@in_child
def test_the_tuners_timing_still_brackets_one_walk(cuda_device, catalog):
    """``Autotuner._timed`` queues its events behind a device sleep; a walk
    launched when no walk is in flight runs on the caller's stream, behind
    the sleep, so the tuner reads the walk's own device time (within 10% of
    the walk run by the executor directly), not the sleep's."""
    import torch
    from repro_torch.core.tuning import Autotuner
    svc, want = _service(cuda_device, catalog)
    sess = svc.session
    plan = svc.prepare_request("a0", 16)
    svc.decode("a0", 16)
    fn = sess.executor.lower(plan)
    plain = np.median([_event_ms(lambda: sess.executor.run(fn, plan), True)
                       for _ in range(5)])
    tuner = Autotuner(svc.session.model, device=cuda_device)
    timed = 1e3 * np.median([tuner._timed(lambda: sess.execute(plan))[1]
                             for _ in range(5)])
    torch.cuda.synchronize()
    assert abs(timed - plain) < 0.1 * plain, (timed, plain)
