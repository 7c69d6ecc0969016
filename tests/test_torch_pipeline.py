"""The port's serving pipeline on the CPU: broker, controller, capability
registry and the metrics instruments, held against the reference.

The reference's ``tests/test_pipeline.py``, ported to the port's service
(``device="cpu"``): the ``LatencyWindow`` and ``OverlapClock`` instruments,
the controller with synthetic clocks, broker round trips (every result equal
to its payload), admission backpressure, the threaded stress at the
reference's size, the capability registry, and ticket cancellation and
timeouts.  The sharded stress runs the same body on a sharded service in
``tests/test_torch_sharded.py``; the three host-materialization tests have
no counterpart: the port keeps streams on the card.

Where a piece is deterministic the port is driven beside the reference with
the same inputs and compared field by field: the controller's estimates,
decisions and budgets; the capability registry's thinned plans, wire
containers and memo counts; and the broker's final counters and per-trace
span names under a configuration that dispatches every request alone.

Every ``result``/``drain``/``chunk`` here has a timeout of at most 30 s.
Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and the port is imported inside the tests, so the test worker itself never
loads torch beside jaxlib.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core.rans import RansParams as JParams, StaticModel as JModel
from repro.runtime.pipeline import (AdaptiveController as JController,
                                    CapabilityRegistry as JRegistry,
                                    ControllerConfig as JConfig)
from repro.runtime.serve import DecodeService as JService

T = 30.0    # every wait in this file is bounded


def _payloads(n_contents=3, size=2048, seed=3):
    rng = np.random.default_rng(seed)
    return {f"c{i}": np.minimum(
        rng.exponential(35.0, size=size).astype(np.int64), 255)
        for i in range(n_contents)}


def _service(payloads, n_splits=16, **kw):
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.runtime.serve import DecodeService
    model = StaticModel.from_symbols(
        np.concatenate(list(payloads.values())), 256,
        RansParams(n_bits=11, ways=32))
    svc = DecodeService(model, device="cpu", **kw)
    svc.ingest_batch(payloads, n_splits)
    return svc


def _ref_service(payloads, n_splits=16, **kw):
    model = JModel.from_symbols(
        np.concatenate(list(payloads.values())), 256,
        JParams(n_bits=11, ways=32))
    svc = JService(model, impl="jnp", **kw)
    svc.ingest_batch(payloads, n_splits)
    return svc


def _frozen_broker(svc, max_queue=512):
    """A broker whose worker can never dispatch on its own (one quantized
    size far above anything queued + an hour-scale deadline), so tests
    control exactly when tickets leave the lanes."""
    from repro_torch.runtime.pipeline import ControllerConfig
    return svc.start_pipeline(
        config=ControllerConfig(max_batch=64, batch_sizes=(64,),
                                target_delay_ms=3_600_000.0),
        max_queue=max_queue)


# ----------------------------------------------------------------------
# Metrics instruments
# ----------------------------------------------------------------------

@in_child
def test_latency_window_percentiles():
    from repro_torch.runtime.metrics import LatencyWindow
    w = LatencyWindow(size=100)
    for ms in range(1, 101):               # 1..100 ms
        w.record(ms * 1e-3)
    assert w.count == 100
    assert abs(w.percentile(50) - 0.0505) < 2e-3
    s = w.summary_ms()
    assert s["count"] == 100
    assert 49 < s["p50_ms"] < 52
    assert 94 < s["p95_ms"] < 97
    assert 98 < s["p99_ms"] <= 100
    assert abs(s["mean_ms"] - 50.5) < 1.0
    assert LatencyWindow().summary_ms()["count"] == 0


@in_child
def test_latency_window_is_bounded():
    from repro_torch.runtime.metrics import LatencyWindow
    w = LatencyWindow(size=8)
    for _ in range(100):
        w.record(1.0)
    for _ in range(8):
        w.record(2.0)                      # overwrite the whole ring
    assert w.percentile(0) == 2.0
    assert w.count == 108


@in_child
def test_overlap_clock_serial_vs_overlapped():
    from repro_torch.runtime.metrics import OverlapClock
    c = OverlapClock("a", "b")
    c.begin("a"); time.sleep(0.02); c.end("a")
    c.begin("b"); time.sleep(0.02); c.end("b")
    assert c.ratio() < 0.2                 # serial: no overlap
    c2 = OverlapClock("a", "b")
    c2.begin("a")
    c2.begin("b"); time.sleep(0.03); c2.end("b")
    c2.end("a")
    assert c2.ratio() > 0.8                # b fully inside a
    snap = c2.snapshot()
    assert snap["overlap_s"] <= snap["a_busy_s"] + 1e-6
    assert 0.0 <= snap["overlap_ratio"] <= 1.0


# ----------------------------------------------------------------------
# Controller (pure, synthetic clock)
# ----------------------------------------------------------------------

@in_child
def test_controller_quantize_and_sizes():
    from repro_torch.runtime.pipeline import (AdaptiveController,
                                              ControllerConfig)
    ctl = AdaptiveController(ControllerConfig(max_batch=8))
    assert ctl.cfg.sizes() == (1, 2, 4, 8)
    assert ctl.quantize(1) == 1
    assert ctl.quantize(3) == 4
    assert ctl.quantize(8) == 8
    assert ctl.quantize(50) == 8           # clamped
    ctl6 = AdaptiveController(ControllerConfig(max_batch=6))
    assert ctl6.cfg.sizes() == (1, 2, 4, 6)


@in_child
def test_controller_targets_track_arrival_rate():
    from repro_torch.runtime.pipeline import (AdaptiveController,
                                              ControllerConfig)
    ctl = AdaptiveController(ControllerConfig(max_batch=8, ema_alpha=0.5))
    ctl.observe_service(8, 8e-3)           # 8 ms per fused dispatch
    t = 0.0
    for _ in range(50):                    # 1000 req/s on lane 16
        ctl.observe_arrival(16, t)
        t += 1e-3
    assert ctl.rate_hz(16, t) > 500
    # 1000/s x 8 ms service -> 8 requests arrive per dispatch
    assert ctl.target_batch(16, t) == 8
    # a quiet lane decays: after 1 s of silence the open gap caps the rate
    assert ctl.rate_hz(16, t + 1.0) <= 1.0 + 1e-6
    assert ctl.target_batch(16, t + 1.0) == 1


@in_child
def test_controller_deadline_forces_partial_flush():
    from repro_torch.runtime.pipeline import (AdaptiveController,
                                              ControllerConfig)
    ctl = AdaptiveController(ControllerConfig(max_batch=8,
                                              target_delay_ms=10.0))
    ctl.observe_service(8, 50e-3)
    t = 0.0
    for _ in range(20):
        ctl.observe_arrival(4, t)
        t += 2e-3                          # 500/s * 50ms -> target 8+
    d = ctl.decide(4, queued=3, oldest_wait_ms=2.0, now=t)
    assert not d.dispatch and d.wait_more_ms <= 8.0
    d = ctl.decide(4, queued=3, oldest_wait_ms=12.0, now=t)
    assert d.dispatch and d.batch == 3     # deadline: take what's there
    d = ctl.decide(4, queued=0, oldest_wait_ms=0.0, now=t)
    assert not d.dispatch


CONFIGS = [
    dict(),
    dict(max_batch=8, ema_alpha=0.5, target_delay_ms=10.0),
    dict(max_batch=6, default_service_ms=2.0, deadline_margin_ms=1.0),
    dict(max_batch=64, batch_sizes=(4, 16, 64), target_delay_ms=40.0,
         deadline_classes=(("gold", 5.0), ("best_effort", 1000.0)),
         default_class="gold"),
]


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
@in_child
def test_controller_equals_reference(cfg):
    """The same seeded sequence of arrivals, service observations, flush
    decisions and budget lookups through the reference's controller and the
    port's copy: every estimate, ``FlushDecision`` and budget is equal,
    field by field, and so is the final snapshot."""
    from repro_torch.runtime.pipeline import (AdaptiveController,
                                              ControllerConfig)
    kw = CONFIGS[cfg]
    j, t = JController(JConfig(**kw)), AdaptiveController(
        ControllerConfig(**kw))
    assert t.cfg.sizes() == j.cfg.sizes()
    assert t.cfg.classes() == j.cfg.classes()
    rng = np.random.default_rng(11 + cfg)
    now = 0.0
    lanes = (1, 4, 16, 2176)
    for _ in range(400):
        now += float(rng.exponential(2e-3))
        lane = int(rng.choice(lanes))
        op = rng.integers(5)
        if op == 0:
            j.observe_arrival(lane, now)
            t.observe_arrival(lane, now)
        elif op == 1:
            b, s = int(rng.integers(1, 80)), float(rng.exponential(5e-3))
            j.observe_service(b, s)
            t.observe_service(b, s)
        elif op == 2:
            args = (lane, int(rng.integers(0, 70)),
                    float(rng.exponential(20.0)), now)
            slack = (None if rng.integers(2) else
                     float(rng.normal(5.0, 10.0)))
            jd = j.decide(*args, flush_slack_ms=slack)
            td = t.decide(*args, flush_slack_ms=slack)
            assert dataclasses.asdict(td) == dataclasses.asdict(jd)
        elif op == 3:
            for cls in (None, *j.cfg.classes(), float(rng.uniform(1, 99))):
                assert t.budget_ms(cls) == j.budget_ms(cls)
        n = int(rng.integers(0, 80))
        assert t.quantize(n) == j.quantize(n)
        assert t.rate_hz(lane, now) == j.rate_hz(lane, now)
        assert t.target_batch(lane, now) == j.target_batch(lane, now)
        assert t.service_s(n) == j.service_s(n)
    for bad in ("premium", -1.0):
        with pytest.raises((KeyError, ValueError)) as je:
            j.budget_ms(bad)
        with pytest.raises(je.type):
            t.budget_ms(bad)
    assert t.snapshot() == j.snapshot()


# ----------------------------------------------------------------------
# Broker
# ----------------------------------------------------------------------

@in_child
def test_broker_roundtrip_warm_zero_recompiles():
    """After ``warm``, traffic resolves no launcher (quantized group
    padding keeps every group on a warmed plan key).  The idle-gap
    predictor is off, so no launcher it resolves speculatively can stand
    in for one that ``warm`` missed."""
    from repro_torch.runtime.pipeline import ControllerConfig
    payloads = _payloads()
    svc = _service(payloads)
    with svc.start_pipeline(
            config=ControllerConfig(max_batch=4, target_delay_ms=5.0),
            predictive=False) as b:
        b.warm(list(payloads), [4, 16])
        before = svc.stats.compiles
        tickets = []
        for i in range(25):                # includes partial (odd) groups
            name = f"c{i % 3}"
            tickets.append((name, svc.submit(name, [4, 16][i % 2])))
        b.drain(timeout=T)
        for name, t in tickets:
            assert (t.result(timeout=T).numpy() == payloads[name]).all(), \
                name
        assert svc.stats.compiles == before, \
            "post-warmup traffic must not resolve a launcher"
        snap = b.snapshot()
        assert snap["queue_depth"] == 0
        assert snap["completed"] == 25
        assert snap["wait"]["count"] == 25
        assert snap["service"]["p50_ms"] >= 0.0
        assert snap["dispatch_errors"] == 0
    assert svc.broker is None              # context exit detaches


@in_child
def test_broker_admission_backpressure():
    from repro_torch.runtime.pipeline import BrokerSaturated, ControllerConfig
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    # batch_sizes=(8,) + huge deadline: the worker cannot dispatch small
    # queues, so the bound is hit deterministically.
    b = svc.start_pipeline(
        config=ControllerConfig(max_batch=8, batch_sizes=(8,),
                                target_delay_ms=60_000.0),
        max_queue=2)
    try:
        t1 = svc.submit("c0", 4)
        t2 = svc.submit("c0", 4)
        with pytest.raises(BrokerSaturated):
            svc.submit("c0", 4)
        assert b.snapshot()["rejected"] == 1
    finally:
        svc.stop_pipeline()                # close() flushes partial lanes
    for t in (t1, t2):
        assert (t.result(timeout=T).numpy() == payloads["c0"]).all()


@in_child
def test_start_pipeline_flushes_sync_pending():
    """Requests queued through the sync path BEFORE the upgrade must not
    strand: start_pipeline dispatches them while attaching (broker-mode
    flush() never touches the sync pending queue)."""
    payloads = _payloads(n_contents=1)
    svc = _service(payloads, microbatch=8)   # group stays below the size
    t_sync = svc.submit("c0", 4)
    with svc.start_pipeline():
        assert (t_sync.result().numpy() == payloads["c0"]).all()
        t_pipe = svc.submit("c0", 4)         # routed to the broker
        assert (t_pipe.result(timeout=T).numpy() == payloads["c0"]).all()


@in_child
def test_broker_rejects_unknown_content_and_closed_broker():
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    b = svc.start_pipeline()
    try:
        with pytest.raises(KeyError):
            svc.submit("nope", 4)
    finally:
        svc.stop_pipeline()
    with pytest.raises(RuntimeError):
        b.submit("c0", 4)


@in_child
def test_broker_ingest_ticket_returns_plan_and_errors_propagate():
    from repro_torch.core.recoil import RecoilPlan
    payloads = _payloads(n_contents=2)
    svc = _service(payloads)
    with svc.start_pipeline() as b:
        t = b.submit_ingest("c9", payloads["c0"], 8)
        plan = t.result(timeout=T)
        assert isinstance(plan, RecoilPlan)
        assert plan.n_threads >= 2
        assert (svc.submit("c9", 8).result(timeout=T).numpy()
                == payloads["c0"]).all()
        # out-of-alphabet symbols: the ingest worker must deliver the
        # validation error through the ticket, not die
        bad = b.submit_ingest("evil", np.full(64, 255_000), 4)
        with pytest.raises(ValueError):
            bad.result(timeout=T)
        assert b.snapshot()["ingest_errors"] == 1


# ----------------------------------------------------------------------
# Threaded stress: concurrent submit during ingest_batch
# ----------------------------------------------------------------------

@in_child
def test_threaded_stress():
    """Concurrent submit during re-ingest across 3 contents, at the
    reference's size: deadlock-free, every result equal to its payload,
    clean error counters (``torch_checks.threaded_stress``)."""
    from torch_checks import stress_payloads, threaded_stress
    payloads = stress_payloads()
    threaded_stress(_service(payloads), payloads, T)


# ----------------------------------------------------------------------
# Capability registry (downscaled plans + containers)
# ----------------------------------------------------------------------

@in_child
def test_capability_registry_downscaling_and_memo():
    from repro_torch.core import container, recoil
    payloads = _payloads(n_contents=1, size=4096)
    svc = _service(payloads, n_splits=32)
    with svc.start_pipeline() as b:
        reg = b.registry
        reg.declare("phone", 2)
        reg.declare("gpu", 32)
        with pytest.raises(KeyError):
            reg.plan_for("c0", "tv")       # undeclared client
        with pytest.raises(ValueError):
            reg.declare("bad", 0)
        p_phone = reg.plan_for("c0", "phone")
        p_gpu = reg.plan_for("c0", "gpu")
        assert p_phone.n_threads == 2 and p_gpu.n_threads == 32
        assert reg.plan_for("c0", "phone") is p_phone   # memoized
        assert reg.snapshot()["memo_hits"] >= 1

        buf_phone = reg.container_for("c0", "phone")
        buf_gpu = reg.container_for("c0", "gpu")
        assert len(buf_phone) < len(buf_gpu)   # thinner metadata on wire
        pc = container.parse(buf_phone, svc.session.model.params)
        out = recoil.decode_recoil(pc.plan, pc.stream, pc.final_states,
                                   pc.model)
        assert (out == payloads["c0"]).all()
        assert pc.plan.n_threads == 2

        # downscaled decode == full-parallelism decode, through the broker
        full = svc.decode("c0", 32).numpy()
        for client in ("phone", "gpu"):
            t = reg.submit_for("c0", client)
            b.drain(timeout=T)
            assert (t.result(timeout=T).numpy() == full).all()


@in_child
def test_capability_registry_invalidates_on_reingest():
    from repro_torch.core import container, recoil
    payloads = _payloads(n_contents=1, size=4096)
    svc = _service(payloads, n_splits=32)
    with svc.start_pipeline() as b:
        reg = b.registry
        reg.declare("c", 4)
        gen0 = svc.generation("c0")
        p0 = reg.plan_for("c0", "c")
        svc.ingest("c0", payloads["c0"], 32)   # refresh bumps generation
        assert svc.generation("c0") == gen0 + 1
        p1 = reg.plan_for("c0", "c")
        assert p1 is not p0                    # stale memo not served
        buf = reg.container_for("c0", "c")
        pc = container.parse(buf, svc.session.model.params)
        out = recoil.decode_recoil(pc.plan, pc.stream, pc.final_states,
                                   pc.model)
        assert (out == payloads["c0"]).all()
        # refreshes overwrite memo entries instead of leaking one plan +
        # one wire payload per generation
        for _ in range(3):
            svc.ingest("c0", payloads["c0"], 32)
            reg.plan_for("c0", "c")
            reg.container_for("c0", "c")
        snap = reg.snapshot()
        assert snap["plans_cached"] == 1
        assert snap["containers_cached"] == 1


def _plan_fields(plan):
    return (plan.n_symbols, plan.n_words, plan.ways, plan.n_threads,
            [(p.offset, p.k.tolist(), p.y.tolist()) for p in plan.points])


@in_child
def test_capability_registry_equals_reference():
    """One declaration and lookup sequence through the reference's registry
    (over the reference's service) and the port's: equal thinned plans,
    byte-equal wire containers, equal memo hit/miss/eviction counts and
    equal snapshots — before and after a re-ingest bumps the generation,
    and under an entry budget."""
    from repro_torch.runtime.pipeline import CapabilityRegistry
    payloads = _payloads(n_contents=2, size=4096)
    tsvc, jsvc = _service(payloads, n_splits=32), _ref_service(
        payloads, n_splits=32)
    for budget in (None, 3):
        regs = (CapabilityRegistry(tsvc, max_entries=budget),
                JRegistry(jsvc, max_entries=budget))
        for reg in regs:
            for client, n in (("phone", 2), ("tablet", 8), ("gpu", 32),
                              ("odd", 5)):
                reg.declare(client, n)
        assert ({k: (v.client_id, v.n_threads)
                 for k, v in regs[0].clients.items()}
                == {k: (v.client_id, v.n_threads)
                    for k, v in regs[1].clients.items()})
        rng = np.random.default_rng(7)
        for step in range(40):
            name = f"c{rng.integers(2)}"
            client = ("phone", "tablet", "gpu", "odd")[rng.integers(4)]
            if step == 20:
                for svc in (tsvc, jsvc):
                    svc.ingest("c1", payloads["c1"], 32)
            t_plan, j_plan = (r.plan_for(name, client) for r in regs)
            assert _plan_fields(t_plan) == _plan_fields(j_plan)
            if rng.integers(2):
                t_buf, j_buf = (r.container_for(name, client) for r in regs)
                assert t_buf == j_buf
            if rng.integers(4) == 0:
                n = int(rng.integers(1, 40))
                t_thr, j_thr = (r.plan_for_threads(name, n) for r in regs)
                assert _plan_fields(t_thr) == _plan_fields(j_thr)
            if step % 9 == 0:
                assert regs[0].prethin(name, 8) is None
                regs[1].prethin(name, 8)
            if step % 13 == 0:
                assert regs[0].evict(name, 8) == regs[1].evict(name, 8)
            assert regs[0].snapshot() == regs[1].snapshot()
        assert regs[0].layout_for("c0") == regs[1].layout_for("c0")


# ----------------------------------------------------------------------
# Ticket cancellation + request timeouts
# ----------------------------------------------------------------------

@in_child
def test_cancel_before_dispatch_drops_at_group_build():
    from repro_torch.runtime.pipeline import TicketCancelled
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    b = _frozen_broker(svc)
    try:
        t_cancel = svc.submit("c0", 4)
        t_live = svc.submit("c0", 4)
        assert t_cancel.cancel() is True
        assert t_cancel.cancel() is False          # already resolved
        with pytest.raises(TicketCancelled):
            t_cancel.result(timeout=1)
    finally:
        svc.stop_pipeline()       # close() flushes the partial lane
    # The cancelled ticket was dropped when the worker built the group:
    # the live request completed, the withdrawn one never hit the engine.
    assert (t_live.result(timeout=T).numpy() == payloads["c0"]).all()
    assert b.snapshot()["cancelled"] == 1
    assert b.snapshot()["completed"] == 1


@in_child
def test_cancel_entire_group_skips_dispatch():
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    b = _frozen_broker(svc)
    try:
        tickets = [svc.submit("c0", 4) for _ in range(3)]
        for t in tickets:
            assert t.cancel()
    finally:
        svc.stop_pipeline()
    snap = b.snapshot()
    assert snap["cancelled"] == 3
    # No group ever reached the engine for the withdrawn requests.
    assert snap["dispatch_groups"] == 0
    assert svc.stats.flushes == 0


@in_child
def test_cancel_in_flight_discards_result():
    """A cancel that lands while the dispatch is running must win: the
    worker's late ``_fulfill`` is discarded and ``result()`` raises."""
    from repro_torch.runtime.pipeline import ControllerConfig, TicketCancelled
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    with svc.start_pipeline(
            config=ControllerConfig(max_batch=2, batch_sizes=(2,),
                                    target_delay_ms=5.0)):
        gate = threading.Event()
        orig = svc.dispatch_group

        def slow_dispatch(requests, tickets):
            gate.set()                    # in flight now
            time.sleep(0.15)
            return orig(requests, tickets)

        svc.dispatch_group = slow_dispatch
        try:
            t1 = svc.submit("c0", 4)
            t2 = svc.submit("c0", 4)      # completes the size-2 group
            assert gate.wait(timeout=T)
            assert t1.cancel() is True    # races the running dispatch
            with pytest.raises(TicketCancelled):
                t1.result(timeout=T)
            assert (t2.result(timeout=T).numpy() == payloads["c0"]).all()
        finally:
            svc.dispatch_group = orig
    # cancel() after completion reports False and the result survives.
    assert t2.cancel() is False
    assert (t2.result(timeout=T).numpy() == payloads["c0"]).all()


@in_child
def test_timeout_while_queued_then_cancel():
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    b = _frozen_broker(svc)
    try:
        t = svc.submit("c0", 4)
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            t.result(timeout=0.1)         # still queued: the frozen worker
        assert time.perf_counter() - t0 < 5.0
        assert not t.done()
        assert t.cancel() is True         # the documented follow-up
    finally:
        svc.stop_pipeline()
    assert b.snapshot()["cancelled"] == 1


@in_child
def test_cancelled_ingest_never_encodes():
    from repro_torch.core.recoil import RecoilPlan
    from repro_torch.runtime.pipeline import TicketCancelled
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    b = svc.start_pipeline()
    try:
        orig = svc.ingest

        def slow_ingest(name, symbols, n_splits):
            time.sleep(0.2)
            return orig(name, symbols, n_splits)

        svc.ingest = slow_ingest
        t_busy = b.submit_ingest("busy", payloads["c0"], 8)
        # Wait until the worker has POPPED the busy event (queue drains to
        # 0 while it sleeps inside slow_ingest), then queue + cancel the
        # target while the worker is provably occupied — the cancel always
        # lands before the next dispatch-group build.
        deadline = time.perf_counter() + T
        while (b.snapshot()["ingest_queue_depth"] > 0
               and time.perf_counter() < deadline):
            time.sleep(0.005)
        t_cancel = b.submit_ingest("never", payloads["c0"], 8)
        assert t_cancel.cancel() is True
        with pytest.raises(TicketCancelled):
            t_cancel.result(timeout=1)
        assert isinstance(t_busy.result(timeout=T), RecoilPlan)
        b.drain(timeout=T)
    finally:
        svc.ingest = orig
        svc.stop_pipeline()
    assert svc.generation("busy") > 0
    assert svc.generation("never") == 0       # dropped before encoding
    assert b.snapshot()["cancelled"] == 1


# ----------------------------------------------------------------------
# The broker against the reference, under a deterministic configuration
# ----------------------------------------------------------------------

# Snapshot keys whose values are host times (held to presence only).
TIMED_KEYS = ("wait", "service", "ingest_service", "overlap", "controller",
              "heat", "admission")


def _drive_broker(svc, cfg_cls, inj, one_by_one):
    """One request sequence through a broker that dispatches every request
    alone (``batch_sizes=(1,)``), each waited for before the next: decodes
    at two capabilities, an ingest, an extend, a stream, a cancelled
    request, a retried fault and an ingest error.  Returns the decoded
    outputs and the broker's snapshot after a drain."""
    cfg = cfg_cls(max_batch=1, batch_sizes=(1,), target_delay_ms=1.0,
                  deadline_classes=(("interactive", 60_000.0),
                                    ("standard", 600_000.0),
                                    ("bulk", 3_600_000.0)))
    outs = []
    b = svc.start_pipeline(config=cfg, predictive=False,
                           retry_backoff_ms=1.0)
    try:
        for name, cap, cls in (("c0", 4, None), ("c1", 16, "interactive"),
                               ("c0", 16, "bulk"), ("c1", 4, 50_000.0)):
            outs.append(np.asarray(
                svc.submit(name, cap, deadline=cls).result(timeout=T)))
        b.submit_ingest("n0", one_by_one["n0"], 8).result(timeout=T)
        outs.append(np.asarray(svc.submit("n0", 8).result(timeout=T)))
        b.submit_extend("n0", one_by_one["delta"]).result(timeout=T)
        outs.append(np.asarray(svc.submit("n0", 8).result(timeout=T)))
        st = b.submit_stream("c1", 16, n_chunks=4)
        outs.append(np.concatenate([np.asarray(st.chunk(i, timeout=T))
                                    for i in range(st.n_chunks)]))
        b.drain(timeout=T)
        inj.arm("service.dispatch_group", times=1)
        outs.append(np.asarray(
            svc.submit("c0", 8, retries=2).result(timeout=T)))
        bad = b.submit_ingest("evil", np.full(64, 255_000), 4)
        with pytest.raises(ValueError):
            bad.result(timeout=T)
        b.drain(timeout=T)
        snap = b.snapshot()
    finally:
        svc.stop_pipeline()
    return outs, snap


@in_child
def test_broker_counters_and_traces_equal_reference():
    """The reference's broker and the port's, each over its own service,
    driven with the same requests under a configuration that makes the
    broker deterministic (every request dispatched alone and waited for,
    prediction off): the outputs are equal, the final snapshot's counters,
    reliability and deadline records, registry and admission bounds are
    equal, and each retained trace has the same kind, name, status and
    span names."""
    from repro.runtime.faultinject import FaultInjector as JInjector
    from repro.runtime.pipeline import ControllerConfig as JCfg
    from repro_torch.runtime.faultinject import FaultInjector
    from repro_torch.runtime.pipeline import ControllerConfig
    payloads = _payloads(n_contents=2)
    extra = {"n0": np.roll(payloads["c0"], 5)[:1500],
             "delta": payloads["c1"][:300]}
    tinj, jinj = FaultInjector(), JInjector()
    tsvc = _service(payloads, faults=tinj)
    jsvc = _ref_service(payloads, faults=jinj)
    t_outs, t_snap = _drive_broker(tsvc, ControllerConfig, tinj, extra)
    j_outs, j_snap = _drive_broker(jsvc, JCfg, jinj, extra)
    for t_out, j_out in zip(t_outs, j_outs, strict=True):
        np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(
        t_outs[5], np.concatenate([extra["n0"], extra["delta"]]))
    assert set(t_snap) == set(j_snap)
    for key in t_snap:
        if key in TIMED_KEYS:
            continue
        assert t_snap[key] == j_snap[key], key
    assert t_snap["admission"]["max_queue"] == j_snap["admission"][
        "max_queue"]
    assert t_snap["submitted"] == t_snap["completed"] + t_snap["cancelled"]
    assert t_snap["retries"] == 1 and t_snap["dispatch_errors"] == 1

    def shape(tr):
        d = tr.to_dict()
        return d["kind"], d["name"], d["status"], [
            s["span"] for s in d["spans"]]

    t_traces = [shape(tr) for tr in tsvc.obs.tracer.recent()]
    j_traces = [shape(tr) for tr in jsvc.obs.tracer.recent()]
    assert t_traces == j_traces
