"""The port's fault points on the CPU: the injector, and every service fault
point ending in a loud error that reaches each ticket it concerns.

The injector is the JAX package's module, copied with one change
(``drop_last_word`` reads the port's int16, bucket-padded resident words);
these tests hold its semantics and drive the service's six fault points —
``service.register`` (a corrupted container, raw words and a resident
``DeviceStream``, must be rejected by registration validation),
``service.ingest``, ``service.extend``, ``service.dispatch_group``,
``service.execute`` and ``service.dispatch_stream`` — plus the group
backend's guards (a length mismatch and an unregistered name fail every
ticket, none strands).  The broker's fault tests wait for the pipeline.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and the port is imported inside the tests, so the test worker itself never
loads torch beside jaxlib.
"""

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
