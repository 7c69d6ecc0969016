"""The port's fault points on the CPU: the injector, every service fault
point ending in a loud error that reaches each ticket it concerns, and the
pipeline broker's supervision and degradation ladder.

The injector is the JAX package's module, copied with one change
(``drop_last_word`` reads the port's int16, bucket-padded resident words);
these tests hold its semantics and drive the service's six fault points —
``service.register`` (a corrupted container, raw words and a resident
``DeviceStream``, must be rejected by registration validation),
``service.ingest``, ``service.extend``, ``service.dispatch_group``,
``service.execute`` and ``service.dispatch_stream`` — plus the group
backend's guards (a length mismatch and an unregistered name fail every
ticket, none strands).  The reference's broker tests follow, ported: a
fault escaping either worker loop is recovered by the supervisor and the
next request is exact; every injected fault ends in a fulfilled-with-error
ticket or a ``ContentQuarantined`` rejection, never a hung ``result()`` or
``drain()``; bounded retry, quarantine with its half-open probe, the fused
-> per-request degraded lane; and the counters' single-writer discipline
under threaded stress.  Every wait has a timeout of at most 30 s.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and the port is imported inside the tests, so the test worker itself never
loads torch beside jaxlib.
"""

import threading
import time

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.runtime.faultinject import drop_last_word as j_drop_last_word


def _payloads(n_contents=3, size=2048, seed=3):
    rng = np.random.default_rng(seed)
    return {f"c{i}": np.minimum(
        rng.exponential(35.0, size=size).astype(np.int64), 255)
        for i in range(n_contents)}


def _service(payloads, n_splits=16, faults=None, **kw):
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.runtime.serve import DecodeService
    model = StaticModel.from_symbols(
        np.concatenate(list(payloads.values())), 256,
        RansParams(n_bits=11, ways=32))
    svc = DecodeService(model, device="cpu", faults=faults, **kw)
    svc.ingest_batch(payloads, n_splits)
    return svc


@in_child
def test_fault_injector_semantics():
    from repro_torch.runtime.faultinject import (NULL_INJECTOR,
                                                 FaultInjected,
                                                 FaultInjector)
    inj = FaultInjector()
    inj.fire("anything")                      # unarmed: no-op
    inj.arm("s", times=2)
    with pytest.raises(FaultInjected):
        inj.fire("s")
    with pytest.raises(FaultInjected):
        inj.fire("s")
    inj.fire("s")                             # exhausted
    assert inj.fires["s"] == 2
    inj.arm("s", exc=KeyError)                # exception class
    with pytest.raises(KeyError):
        inj.fire("s")
    boom = RuntimeError("boom")
    inj.arm("s", exc=boom, times=None)        # instance + raise-always
    for _ in range(3):
        with pytest.raises(RuntimeError, match="boom"):
            inj.fire("s")
    inj.arm("m", match=lambda ctx: ctx.get("name") == "bad")
    inj.fire("m", name="good")                # predicate filters firings
    with pytest.raises(FaultInjected):
        inj.fire("m", name="bad")
    t0 = time.perf_counter()
    inj.arm("d", mode="delay", delay_s=0.05)
    inj.fire("d")
    assert time.perf_counter() - t0 >= 0.05
    inj.arm("c", mode="corrupt", mutate=lambda v: v + 1)
    assert inj.corrupt("c", 41) == 42
    assert inj.corrupt("c", 41) == 41         # corrupt times=1 exhausted
    inj.fire("c")                             # corrupt spec never raises
    snap = inj.snapshot()
    assert set(snap["armed"]) == {"s", "m", "d", "c"}
    assert snap["fired"]["c"] == 1
    inj.disarm("s")
    inj.fire("s")
    inj.disarm()
    assert inj.armed == ()
    with pytest.raises(ValueError):
        inj.arm("x", mode="nope")
    with pytest.raises(ValueError):
        inj.arm("x", mode="corrupt")          # corrupt requires mutate
    NULL_INJECTOR.fire("s")
    assert NULL_INJECTOR.corrupt("s", 7) == 7
    assert NULL_INJECTOR.snapshot() == {"armed": [], "fired": {}}


@in_child
def test_drop_last_word_reads_the_ports_stream():
    """The one change to the copy: resident words are int16 bit patterns
    padded to the bucket, so the truncation takes the first n_words - 1
    words as u16 — from the handle's host copy, or from the device words
    when the handle has none (ingested content)."""
    import dataclasses

    from repro_torch.runtime.faultinject import drop_last_word
    payloads = _payloads(1)
    svc = _service(payloads)
    ds = svc.content("c0").stream
    assert ds.host is None                    # ingested: words on the device
    words = ds.words[:ds.n_words].numpy().view(np.uint16)
    assert words.max() >= 1 << 15             # u16 values an int16 misreads
    got = drop_last_word(ds)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, words[:-1])
    hosted = dataclasses.replace(ds, host=words.copy())
    np.testing.assert_array_equal(drop_last_word(hosted), words[:-1])
    np.testing.assert_array_equal(drop_last_word(words),
                                  j_drop_last_word(words))


@in_child
def test_corrupted_container_rejected_at_registration():
    """A poisoned container is caught by registration validation, before it
    can reach serving state, whether it arrives as raw words or as a
    resident DeviceStream (ingest); the registered version keeps serving
    bit-exactly, and the exhausted injector lets the next one through."""
    from repro_torch.runtime.faultinject import FaultInjector, drop_last_word
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    gen = svc.generation("c0")
    c = svc.content("c0")
    words = c.stream.words[:c.stream.n_words].numpy().view(np.uint16).copy()
    for stream in (words, c.stream):
        inj.arm("service.register", mode="corrupt", mutate=drop_last_word)
        with pytest.raises(ValueError, match="words"):
            svc.register("c0", c.plan, stream, c.final_states)
        assert svc.generation("c0") == gen
        np.testing.assert_array_equal(svc.decode("c0", 8).numpy(),
                                      payloads["c0"])
    inj.arm("service.register", mode="corrupt", mutate=drop_last_word)
    with pytest.raises(ValueError, match="words"):
        svc.ingest("c0", payloads["c0"], 16)
    assert inj.fires["service.register"] == 3
    svc.ingest("c0", payloads["c0"], 16)      # injector exhausted
    assert svc.generation("c0") == gen + 1
    np.testing.assert_array_equal(svc.decode("c0", 8).numpy(),
                                  payloads["c0"])


@in_child
def test_ingest_and_extend_fault_points():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    inj = FaultInjector()
    payloads = _payloads(2)
    svc = _service(payloads, faults=inj)
    svc.ingest("grow", payloads["c0"], 8)
    inj.arm("service.ingest", match=lambda ctx: ctx["name"] == "new")
    with pytest.raises(FaultInjected):
        svc.ingest("new", payloads["c1"], 8)
    assert svc.generation("new") == 0         # nothing registered
    inj.arm("service.extend")
    with pytest.raises(FaultInjected):
        svc.extend("grow", payloads["c1"][:100])
    assert svc.stats.extends == 0
    svc.extend("grow", payloads["c1"][:100])  # exhausted: extends cleanly
    np.testing.assert_array_equal(
        svc.decode("grow", 8).numpy(),
        np.concatenate([payloads["c0"], payloads["c1"][:100]]))
    assert inj.fires == {"service.ingest": 1, "service.extend": 1}


@in_child
def test_dispatch_group_length_guard_fulfills_all_tickets():
    from repro_torch.runtime.serve import DecodeTicket
    payloads = _payloads(1)
    svc = _service(payloads)
    tickets = [DecodeTicket(svc) for _ in range(3)]
    with pytest.raises(ValueError, match="align positionally"):
        svc.dispatch_group([("c0", 4), ("c0", 4)], tickets)
    for t in tickets:
        assert isinstance(t.err, ValueError)  # none stranded
        with pytest.raises(ValueError):
            t.result()


@in_child
def test_dispatch_group_unregistered_name_fails_every_ticket():
    from repro_torch.runtime.serve import DecodeTicket
    payloads = _payloads(2)
    svc = _service(payloads)
    tickets = [DecodeTicket(svc) for _ in range(3)]
    with pytest.raises(KeyError, match="nope"):
        svc.dispatch_group([("c0", 4), ("nope", 4), ("c1", 8)], tickets)
    for t in tickets:
        assert isinstance(t.err, KeyError)
    assert svc.stats.fused_dispatches == 0
    with pytest.raises(KeyError, match="nope"):
        svc.prepare_group([("c0", 4), ("nope", 4)])


@in_child
def test_dispatch_group_and_execute_faults_fulfill_the_group():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    from repro_torch.runtime.serve import DecodeTicket
    inj = FaultInjector()
    payloads = _payloads(2)
    svc = _service(payloads, faults=inj)
    reqs = [("c0", 4), ("c1", 8)]
    for site in ("service.dispatch_group", "service.execute"):
        inj.arm(site)
        tickets = [DecodeTicket(svc) for _ in reqs]
        with pytest.raises(FaultInjected):
            svc.dispatch_group(reqs, tickets)
        for t in tickets:
            with pytest.raises(FaultInjected):
                t.result()
    # The sync path: the execute fault reaches both pending tickets.
    inj.arm("service.execute")
    pending = [svc.submit(n, th) for n, th in reqs]
    with pytest.raises(FaultInjected):
        svc.flush()
    for t in pending:
        with pytest.raises(FaultInjected):
            t.result()
        assert t.trace.status == "error"
    tickets = [DecodeTicket(svc) for _ in reqs]
    svc.dispatch_group(reqs, tickets)         # exhausted: serves again
    for t, (name, _) in zip(tickets, reqs):
        np.testing.assert_array_equal(t.result().numpy(), payloads[name])


@in_child
def test_dispatch_stream_fault_reaches_the_ticket():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    from repro_torch.runtime.serve import StreamTicket
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    inj.arm("service.dispatch_stream")
    with pytest.raises(FaultInjected):
        svc.submit_stream("c0", 8, n_chunks=4)
    inj.arm("service.dispatch_stream")
    ticket = StreamTicket(svc.stream_chunk_count("c0", 8, 4))
    with pytest.raises(FaultInjected):
        svc.dispatch_stream("c0", 8, 4, ticket)
    with pytest.raises(FaultInjected):
        ticket.chunk(0, timeout=10)
    assert svc.obs.tracer.snapshot()["finished"] == {"error": 1}
    assert svc.stats.stream_requests == 0
    st = svc.submit_stream("c0", 8, n_chunks=4)
    np.testing.assert_array_equal(st.result().numpy(), payloads["c0"])
    assert svc.metrics()["recoil_faults_fired_total"]["values"][
        "service.dispatch_stream"] == 2


# ----------------------------------------------------------------------
# The broker: supervised workers
# ----------------------------------------------------------------------

DRAIN_S = 30.0      # finite: drain() must RETURN


def _fast_config(**kw):
    """Dispatch promptly (small groups, short accumulation window)."""
    from repro_torch.runtime.pipeline import ControllerConfig
    return ControllerConfig(max_batch=4, target_delay_ms=2.0, **kw)


def _stream(st):
    return np.concatenate([st.chunk(i, timeout=DRAIN_S).numpy()
                           for i in range(st.n_chunks)])


@in_child
def test_supervisor_recovers_decode_worker():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config()) as b:
        inj.arm("broker.decode_worker")       # escapes dispatch handling
        t = svc.submit("c0", 4)
        with pytest.raises(FaultInjected):
            t.result(timeout=DRAIN_S)
        b.drain(timeout=DRAIN_S)              # the crashed iteration's
        snap = b.snapshot()                   # inflight slot was restored
        assert snap["worker_restarts"] == 1
        assert snap["queue_depth"] == 0
        # The restarted worker serves the next request bit-exactly.
        t2 = svc.submit("c0", 4)
        assert (t2.result(timeout=DRAIN_S).numpy() == payloads["c0"]).all()
        b.drain(timeout=DRAIN_S)
        assert b.snapshot()["completed"] == 2


@in_child
def test_supervisor_recovers_ingest_worker():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    fresh = np.roll(payloads["c0"], 7)   # same symbol set: model covers it
    with svc.start_pipeline(config=_fast_config()) as b:
        inj.arm("broker.ingest_worker")
        t = b.submit_ingest("n0", fresh, 16)
        with pytest.raises(FaultInjected):
            t.result(timeout=DRAIN_S)
        b.drain(timeout=DRAIN_S)
        snap = b.snapshot()
        assert snap["worker_restarts"] == 1
        assert snap["ingest_errors"] == 1
        # Restarted ingest worker registers and the content round-trips.
        t2 = b.submit_ingest("n0", fresh, 16)
        t2.result(timeout=DRAIN_S)
        t3 = svc.submit("n0", 8)
        assert (t3.result(timeout=DRAIN_S).numpy() == fresh).all()


@in_child
def test_quantize_fault_does_not_kill_worker():
    """The quantize step and filler construction run inside the dispatch
    error handling: a fault there reaches the ticket, drain returns, and
    no restart is needed."""
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config()) as b:
        inj.arm("broker.quantize")
        t = svc.submit("c0", 4)
        with pytest.raises(FaultInjected):
            t.result(timeout=DRAIN_S)
        b.drain(timeout=DRAIN_S)              # MUST return
        snap = b.snapshot()
        assert snap["dispatch_errors"] == 1
        assert snap["worker_restarts"] == 0   # handled, not crashed
        t2 = svc.submit("c0", 4)
        assert (t2.result(timeout=DRAIN_S).numpy() == payloads["c0"]).all()


@in_child
def test_stream_fault_fulfills_ticket_and_drains():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config()) as b:
        inj.arm("service.dispatch_stream")
        st = svc.submit_stream("c0", 8, n_chunks=4)
        with pytest.raises(FaultInjected):
            st.chunk(0, timeout=DRAIN_S)
        b.drain(timeout=DRAIN_S)
        assert b.snapshot()["dispatch_errors"] == 1
        st2 = svc.submit_stream("c0", 8, n_chunks=4)
        assert (_stream(st2) == payloads["c0"]).all()


@in_child
def test_execute_boundary_fault_fulfills_group():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    inj = FaultInjector()
    payloads = _payloads(2)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config()) as b:
        inj.arm("service.execute")
        t = svc.submit("c0", 4)
        with pytest.raises(FaultInjected):
            t.result(timeout=DRAIN_S)
        b.drain(timeout=DRAIN_S)
        assert b.snapshot()["dispatch_errors"] == 1
        t2 = svc.submit("c1", 4)
        assert (t2.result(timeout=DRAIN_S).numpy() == payloads["c1"]).all()


@in_child
def test_delay_fault_completes_without_errors():
    """A delay fault stretches latency but must not surface as an error
    anywhere."""
    from repro_torch.runtime.faultinject import FaultInjector
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config()) as b:
        inj.arm("service.execute", mode="delay", delay_s=0.05)
        t0 = time.perf_counter()
        t = svc.submit("c0", 4)
        out = t.result(timeout=DRAIN_S)
        assert time.perf_counter() - t0 >= 0.05
        assert (out.numpy() == payloads["c0"]).all()
        b.drain(timeout=DRAIN_S)
        snap = b.snapshot()
        assert snap["dispatch_errors"] == 0 == snap["worker_restarts"]


# ----------------------------------------------------------------------
# The broker: retry, quarantine, degraded lanes
# ----------------------------------------------------------------------

@in_child
def test_retry_transient_fault_succeeds():
    from repro_torch.runtime.faultinject import FaultInjector
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config(),
                            retry_backoff_ms=1.0) as b:
        inj.arm("service.dispatch_group", times=1)     # raise-once
        t = svc.submit("c0", 4, retries=2)
        assert (t.result(timeout=DRAIN_S).numpy() == payloads["c0"]).all()
        b.drain(timeout=DRAIN_S)
        snap = b.snapshot()
        assert snap["retries"] == 1
        assert snap["dispatch_errors"] == 1
        assert snap["completed"] == 1
        assert snap["reliability"]["retry_queue_depth"] == 0


@in_child
def test_retry_budget_exhaustion_delivers_error():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config(), retry_backoff_ms=1.0,
                            quarantine_after=99) as b:
        inj.arm("service.dispatch_group", times=None)  # raise-always
        t = svc.submit("c0", 4, retries=2)
        with pytest.raises(FaultInjected):
            t.result(timeout=DRAIN_S)
        b.drain(timeout=DRAIN_S)
        snap = b.snapshot()
        assert snap["retries"] == 2                    # budget spent exactly
        assert snap["dispatch_errors"] == 3            # 1 + 2 retries
        assert snap["completed"] == 1


@in_child
def test_no_retry_without_opt_in():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config()) as b:
        inj.arm("service.dispatch_group", times=1)
        t = svc.submit("c0", 4)                        # retries=0 default
        with pytest.raises(FaultInjected):
            t.result(timeout=DRAIN_S)
        b.drain(timeout=DRAIN_S)
        assert b.snapshot()["retries"] == 0


@in_child
def test_quarantine_lifecycle():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    from repro_torch.runtime.pipeline import ContentQuarantined
    inj = FaultInjector()
    payloads = _payloads(2)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config(), quarantine_after=2,
                            quarantine_s=30.0) as b:
        inj.arm("service.dispatch_group", times=None,
                match=lambda ctx: "c0" in ctx["names"])
        for _ in range(2):                             # reach the threshold
            t = svc.submit("c0", 4)
            with pytest.raises(FaultInjected):
                t.result(timeout=DRAIN_S)
            b.drain(timeout=DRAIN_S)
        # Quarantined: refused at admission with a retry hint, the lane is
        # never wedged with guaranteed-to-fail dispatches.
        with pytest.raises(ContentQuarantined) as exc:
            svc.submit("c0", 4)
        assert 0.0 < exc.value.retry_after_s <= 30.0
        snap = b.snapshot()
        assert snap["reliability"]["quarantined"] == 1
        assert snap["quarantine_rejects"] == 1
        assert snap["reliability"]["quarantined_contents"] == ["c0"]
        # Healthy content on the same lane is unaffected.
        t = svc.submit("c1", 4)
        assert (t.result(timeout=DRAIN_S).numpy() == payloads["c1"]).all()


@in_child
def test_quarantine_half_open_probe():
    from repro_torch.runtime.faultinject import FaultInjected, FaultInjector
    from repro_torch.runtime.pipeline import ContentQuarantined
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config(), quarantine_after=2,
                            quarantine_s=0.05) as b:
        inj.arm("service.dispatch_group", times=None)
        for _ in range(2):
            t = svc.submit("c0", 4)
            with pytest.raises(FaultInjected):
                t.result(timeout=DRAIN_S)
            b.drain(timeout=DRAIN_S)
        with pytest.raises(ContentQuarantined):
            svc.submit("c0", 4)
        time.sleep(0.1)                       # expiry -> half-open
        # Probe fails while the fault persists: re-quarantined immediately
        # (fault count was held at threshold-1).
        t = svc.submit("c0", 4)
        with pytest.raises(FaultInjected):
            t.result(timeout=DRAIN_S)
        b.drain(timeout=DRAIN_S)
        with pytest.raises(ContentQuarantined):
            svc.submit("c0", 4)
        assert b.snapshot()["reliability"]["quarantined"] == 2
        time.sleep(0.1)
        inj.disarm()                          # fault fixed: probe succeeds
        t = svc.submit("c0", 4)
        assert (t.result(timeout=DRAIN_S).numpy() == payloads["c0"]).all()
        b.drain(timeout=DRAIN_S)   # result() can return before the worker's
        snap = b.snapshot()["reliability"]   # success bookkeeping runs
        assert snap["quarantined_contents"] == []     # record cleared
        assert snap["content_faults"] == {}


@in_child
def test_degraded_mode_falls_back_to_singles_and_recovers():
    """A lane whose FUSED path keeps faulting (here: the quantize step,
    which per-request dispatch never runs) degrades to singles — the
    retried ticket then succeeds — and ``degraded_probe`` clean singles
    re-earn fusion."""
    from repro_torch.runtime.faultinject import FaultInjector
    inj = FaultInjector()
    payloads = _payloads(1)
    svc = _service(payloads, faults=inj)
    with svc.start_pipeline(config=_fast_config(), retry_backoff_ms=1.0,
                            degrade_after=2, degraded_probe=2,
                            quarantine_after=99) as b:
        inj.arm("broker.quantize", times=None)         # fused path only
        t = svc.submit("c0", 4, retries=3)
        assert (t.result(timeout=DRAIN_S).numpy() == payloads["c0"]).all()
        b.drain(timeout=DRAIN_S)
        snap = b.snapshot()
        assert snap["degraded_dispatches"] >= 1
        assert snap["dispatch_errors"] == 2            # the 2 fused faults
        assert 4 in snap["reliability"]["degraded_lanes"]
        inj.disarm()   # fused path healthy again before fusion resumes
        # The retried single already paid one probe down (2 -> 1); one more
        # clean single restores fusion.
        t = svc.submit("c0", 4)
        assert (t.result(timeout=DRAIN_S).numpy() == payloads["c0"]).all()
        b.drain(timeout=DRAIN_S)
        assert b.snapshot()["reliability"]["degraded_lanes"] == []
        # Back on the (healthy) fused path, still bit-exact.
        t = svc.submit("c0", 4)
        assert (t.result(timeout=DRAIN_S).numpy() == payloads["c0"]).all()


# ----------------------------------------------------------------------
# The broker: counter integrity under races
# ----------------------------------------------------------------------

@in_child
def test_counter_integrity_under_threaded_stress():
    from repro_torch.runtime.faultinject import FaultInjector
    inj = FaultInjector()
    payloads = _payloads(3)
    svc = _service(payloads, faults=inj)
    monotone = ("submitted", "completed", "cancelled", "dispatch_groups",
                "dispatch_errors", "retries", "worker_restarts",
                "stream_dispatches", "ingest_dispatches")
    with svc.start_pipeline(config=_fast_config(),
                            retry_backoff_ms=1.0) as b:
        inj.arm("service.dispatch_group", times=3)     # absorbed by retries
        stop = threading.Event()
        violations: list[str] = []

        def sample():
            prev = {k: 0 for k in monotone}
            while not stop.is_set():
                s = b.snapshot()
                for k in monotone:
                    if s[k] < prev[k]:
                        violations.append(f"{k} went backwards: "
                                          f"{prev[k]} -> {s[k]}")
                    prev[k] = s[k]
                if s["submitted"] < s["completed"] + s["cancelled"]:
                    violations.append(
                        f"torn cut: submitted {s['submitted']} < completed "
                        f"{s['completed']} + cancelled {s['cancelled']}")

        tickets = []
        tlock = threading.Lock()

        def client(seed):
            for i in range(30):
                name = f"c{(seed + i) % 3}"
                t = svc.submit(name, [4, 16][i % 2], retries=2)
                with tlock:
                    tickets.append((name, t))

        sampler = threading.Thread(target=sample)
        clients = [threading.Thread(target=client, args=(s,))
                   for s in range(3)]
        sampler.start()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=DRAIN_S)
        b.drain(timeout=DRAIN_S)
        stop.set()
        sampler.join(timeout=DRAIN_S)
        assert not violations, violations[:5]
        snap = b.snapshot()
        assert snap["submitted"] == 90
        assert snap["completed"] + snap["cancelled"] == 90
        assert snap["dispatch_errors"] == 3
        assert snap["retries"] >= 3
        for name, t in tickets:               # retries absorbed every fault
            assert (t.result(timeout=DRAIN_S).numpy()
                    == payloads[name]).all(), name
