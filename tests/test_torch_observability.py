"""The port's observability tier on the CPU: ticket traces, the metrics
registry, the launcher profiler in both sessions, and the metrics schema.

The reference's observability tests, ported to the port's service
(``device="cpu"``): trace primitives, the registry and profiler, the
``LatencyWindow`` reset and concurrency, span trees through the sync path,
a stream and the pipeline broker (a warm round trip whose span-sum matches
its end-to-end latency, ingest and stream trees, cancels, a result timeout,
an admission rejection, deadline-miss accounting), a check that the port's
``SCHEMA`` is the reference's less a stated list of names whose source the
port does not have, with equal types and labels for every other name (a
running broker yields every ``recoil_broker_*`` name), and one traffic
sequence, sync path then broker, driven through the port's service and the
reference's (``impl="jnp"``) whose counters and trace span trees must
agree.  Every broker wait here has a timeout of at most 30 s.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and the port is imported inside the tests, so the test worker itself never
loads torch beside jaxlib.
"""

import json
import threading
import time

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core.rans import RansParams as JParams, StaticModel as JModel
from repro.runtime.faultinject import FaultInjector as JInjector
from repro.runtime.observability import SCHEMA as J_SCHEMA
from repro.runtime.pipeline import ControllerConfig as JConfig
from repro.runtime.serve import DecodeService as JService
from repro.runtime.serve import DecodeTicket as JTicket

# The reference's metric names that the port leaves out: the encoder has no
# executable cache or fast/full tier, no executor copies streams to the
# host, and the port has no bucket policy for the policy label.
LEFT_OUT = (
    "recoil_service_encode_compiles_total",
    "recoil_service_encode_fallbacks_total",
    "recoil_service_host_materializations_total",
    "recoil_engine_host_materialized_bytes_total",
    "recoil_engine_policy_info",
)

# Metrics whose values are host times, so differ between packages: held to
# equal label sets (and, for the histogram, equal counts per label) only.
TIMED = ("recoil_profiler_compile_seconds_total",
         "recoil_profiler_run_seconds_total", "recoil_request_latency_ms",
         "recoil_broker_wait_ms", "recoil_broker_service_ms",
         "recoil_broker_ingest_service_ms", "recoil_broker_overlap_ratio",
         "recoil_controller_lane_rate_hz", "recoil_controller_service_ms")

T = 30.0    # every broker wait in this file is bounded

REQUIRED_SPANS = {"admission", "queue", "coalesce", "dispatch", "execute",
                  "delivery"}


def _payloads(n_contents=2, size=2048, seed=3):
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


def _config(**kw):
    from repro_torch.runtime.pipeline import ControllerConfig
    return ControllerConfig(**kw)


def _frozen_broker(svc, **kw):
    """A broker whose worker never dispatches on its own — tests control
    exactly when tickets leave the lanes."""
    return svc.start_pipeline(
        config=_config(max_batch=64, batch_sizes=(64,),
                       target_delay_ms=3_600_000.0), **kw)


# ----------------------------------------------------------------------
# Trace primitives
# ----------------------------------------------------------------------

@in_child
def test_trace_spans_tile_and_sum_exactly():
    from repro_torch.runtime.observability import TicketTracer
    tr = TicketTracer().start("decode", name="x", t0=10.0)
    tr.phase("admission", 10.5)
    tr.phase("queue", 12.0)
    tr.phase("execute", 15.0)
    tr.finish("ok", 15.25)
    assert tr.status == "ok"
    assert tr.span_names() == ["admission", "queue", "execute", "ok"]
    assert tr.span_sum_s() == pytest.approx(tr.duration_s)
    assert tr.duration_s == pytest.approx(5.25)
    d = tr.to_dict()
    assert d["duration_ms"] == pytest.approx(5250.0)
    assert [s["span"] for s in d["spans"]] == tr.span_names()
    assert sum(s["dur_ms"] for s in d["spans"]) == \
        pytest.approx(d["duration_ms"], rel=1e-6)


@in_child
def test_trace_finish_is_idempotent_and_drops_late_phases():
    from repro_torch.runtime.observability import TicketTracer
    tr = TicketTracer().start("decode", t0=0.0)
    tr.phase("queue", 1.0)
    tr.finish("cancelled", 2.0)
    tr.phase("execute", 3.0)      # a racing dispatch after the cancel won
    tr.finish("ok", 4.0)
    assert tr.status == "cancelled"
    assert tr.span_names() == ["queue", "cancelled"]
    assert tr.duration_s == pytest.approx(2.0)
    tr.event("result_timeout", 5.0, timeout_s=1.0)
    assert tr.span_names()[-1] == "result_timeout"
    assert tr.span_sum_s() == pytest.approx(2.0)   # events are zero-width


@in_child
def test_null_trace_is_inert():
    from repro_torch.runtime.observability import NULL_TRACE
    assert NULL_TRACE.live is False
    assert NULL_TRACE.phase("x") is None
    assert NULL_TRACE.finish("ok") is None
    assert NULL_TRACE.to_dict() == {}


@in_child
def test_tracer_ring_bound_and_jsonl_export(tmp_path):
    from repro_torch.runtime.observability import TicketTracer
    tracer = TicketTracer(capacity=4)
    for i in range(10):
        t = tracer.start("decode", name=f"n{i}", t0=float(i))
        t.finish("ok", float(i) + 0.5)
    snap = tracer.snapshot()
    assert snap["started"] == 10
    assert snap["retained"] == 4
    assert snap["finished"] == {"ok": 10}
    assert [t.name for t in tracer.recent()] == ["n6", "n7", "n8", "n9"]
    path = tmp_path / "traces.jsonl"
    assert tracer.export_jsonl(str(path)) == 4
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["name"] for r in rows] == ["n6", "n7", "n8", "n9"]
    assert all(r["status"] == "ok" for r in rows)


@in_child
def test_tracer_disabled_hands_out_null_trace():
    from repro_torch.runtime.observability import NULL_TRACE, TicketTracer
    tracer = TicketTracer(enabled=False)
    assert tracer.start("decode") is NULL_TRACE
    assert tracer.snapshot()["started"] == 0


# ----------------------------------------------------------------------
# Metrics registry and profiler
# ----------------------------------------------------------------------

@in_child
def test_registry_instruments_and_exposition():
    from repro_torch.runtime.observability import MetricsRegistry
    reg = MetricsRegistry()
    c = reg.counter("req_total", "requests", labelnames=("kind",))
    c.labels(kind="a").inc()
    c.labels(kind="a").inc(2)
    c.labels(kind="b").inc()
    g = reg.gauge("depth")
    g.set(7)
    h = reg.histogram("lat_ms", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)
    h.observe(50.0)
    snap = reg.snapshot()
    assert snap["req_total"]["values"] == {"a": 3.0, "b": 1.0}
    assert snap["depth"]["values"][""] == 7.0
    hval = snap["lat_ms"]["values"][""]
    assert hval["count"] == 3 and hval["sum"] == pytest.approx(55.5)
    assert hval["buckets"] == {1.0: 1, 10.0: 2}
    text = reg.exposition()
    assert '# TYPE req_total counter' in text
    assert 'req_total{kind="a"} 3' in text
    assert 'lat_ms_bucket{le="+Inf"} 3' in text
    assert 'lat_ms_count 3' in text
    with pytest.raises(ValueError):
        reg.counter("req_total", labelnames=())
    with pytest.raises(ValueError):
        c.labels(kind="a").inc(-1)
    with pytest.raises(TypeError):
        g.observe(1.0)


@in_child
def test_registry_collectors_merge_and_collide_loudly():
    from repro_torch.runtime.observability import MetricsRegistry
    reg = MetricsRegistry()
    reg.register_collector(lambda: [
        {"name": "ext_total", "type": "counter", "value": 5},
        {"name": "ext_depth", "type": "gauge", "value": 2,
         "labels": {"lane": "8"}}])
    snap = reg.snapshot()
    assert snap["ext_total"]["values"][""] == 5
    assert snap["ext_depth"]["values"]["8"] == 2
    reg.counter("ext_total").inc()
    with pytest.raises(ValueError):
        reg.snapshot()


@in_child
def test_profiler_records_and_bounds_keys():
    from repro_torch.runtime.observability import ExecProfiler
    prof = ExecProfiler(max_keys=2)
    prof.record_compile("decode", ("k1",), 0.5)
    prof.record_run("decode", ("k1",), 0.1)
    prof.record_run("decode", ("k2",), 0.2)
    prof.record_run("decode", ("k3",), 0.3)
    t = prof.totals("decode")
    assert t == {"keys": 3, "compiles": 1, "compile_s": 0.5,
                 "runs": 3, "run_s": pytest.approx(0.6)}
    keys = {row["key"] for row in prof.snapshot()["decode"]["top"]}
    assert ExecProfiler.OVERFLOW in keys
    assert ExecProfiler(enabled=False).totals("decode")["runs"] == 0


# ----------------------------------------------------------------------
# LatencyWindow (thread-safety + reset)
# ----------------------------------------------------------------------

@in_child
def test_latency_window_reset_isolates_phases():
    from repro_torch.runtime.metrics import LatencyWindow
    w = LatencyWindow(size=16)
    for _ in range(8):
        w.record(1.0)                             # cold phase
    w.reset()
    assert w.count == 0
    assert w.summary_ms()["count"] == 0
    w.record(0.002)                               # warm phase only
    s = w.summary_ms()
    assert s["count"] == 1
    assert s["p99_ms"] == pytest.approx(2.0)      # no cold-tail leakage


@in_child
def test_latency_window_concurrent_recorders():
    from repro_torch.runtime.metrics import LatencyWindow
    w = LatencyWindow(size=64)
    stop = threading.Event()

    def pound():
        while not stop.is_set():
            w.record(0.001)
            w.summary_ms()

    threads = [threading.Thread(target=pound) for _ in range(4)]
    for t in threads:
        t.start()
    for _ in range(50):
        w.reset()
        w.percentile(99)
    stop.set()
    for t in threads:
        t.join()
    assert w.summary_ms()["p50_ms"] in (0.0, pytest.approx(1.0))


# ----------------------------------------------------------------------
# Span trees through the service
# ----------------------------------------------------------------------

@in_child
def test_sync_path_span_tree():
    payloads = _payloads(n_contents=1)
    svc = _service(payloads, microbatch=2, max_delay_ms=10_000.0)
    t1 = svc.submit("c0", 8)
    t2 = svc.submit("c0", 8)                      # completes the microbatch
    np.testing.assert_array_equal(t1.result().numpy(), payloads["c0"])
    for t in (t1, t2):
        assert t.trace.status == "ok"
        assert REQUIRED_SPANS <= set(t.trace.span_names())
        assert t.trace.span_sum_s() == pytest.approx(t.trace.duration_s)
    assert t1.trace.meta["path"] == "sync"
    recent = svc.obs.tracer.recent(kind="decode", status="ok")
    assert len(recent) == 2
    from repro_torch.runtime.observability import waterfall
    art = waterfall(recent[-1])
    assert "execute" in art and "[ok]" in art


@in_child
def test_stream_span_tree():
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    st = svc.submit_stream("c0", 8, n_chunks=4)
    np.testing.assert_array_equal(st.result().numpy(), payloads["c0"])
    tr = st.trace
    assert tr.status == "ok" and tr.kind == "stream"
    assert tr.span_names() == ["admission", "dispatch", "execute", "ok"]
    assert tr.to_dict()["spans"][1]["meta"] == {"chunks": 4}
    assert tr.span_sum_s() == pytest.approx(tr.duration_s)
    assert svc.obs.tracer.recent(kind="stream", status="ok") == [tr]
    lat = svc.metrics()["recoil_request_latency_ms"]["values"]
    assert lat["stream|ok"]["count"] == 1


# ----------------------------------------------------------------------
# Span trees through the broker
# ----------------------------------------------------------------------

@in_child
def test_warm_roundtrip_span_tree_matches_e2e_latency():
    from repro_torch.runtime.observability import waterfall
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    with svc.start_pipeline(config=_config(
            max_batch=4, batch_sizes=(4,), target_delay_ms=5.0)):
        for _ in range(2):                        # warm the group shape
            tks = [svc.submit("c0", 8) for _ in range(4)]
            for t in tks:
                t.result(timeout=T)
        tks = [svc.submit("c0", 8) for _ in range(4)]
        outs = [t.result(timeout=T) for t in tks]
    for t, out in zip(tks, outs):
        np.testing.assert_array_equal(out.numpy(), payloads["c0"])
        tr = t.trace
        assert tr.status == "ok"
        assert REQUIRED_SPANS <= set(tr.span_names())
        e2e = t.completed_at - t.submitted_at
        # Span-sum within 10% of the measured end-to-end latency.
        assert tr.span_sum_s() == pytest.approx(e2e, rel=0.10)
        # And internally exact: phases tile the trace lifetime.
        assert tr.span_sum_s() == pytest.approx(tr.duration_s, rel=1e-9)
    # The finished traces landed in the ring and the waterfall renders.
    recent = svc.obs.tracer.recent(kind="decode", status="ok")
    assert len(recent) >= 4
    art = waterfall(recent[-1])
    assert "execute" in art and "[ok]" in art


@in_child
def test_ingest_and_stream_span_trees():
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    with svc.start_pipeline() as b:
        it = b.submit_ingest("new", payloads["c0"], 8)
        it.result(timeout=T)
        st = b.submit_stream("new", 8, n_chunks=4)
        got = [st.chunk(i, timeout=T).numpy() for i in range(st.n_chunks)]
        np.testing.assert_array_equal(np.concatenate(got), payloads["c0"])
        b.drain(timeout=T)
        assert it.trace.status == "ok"
        assert {"admission", "queue", "execute"} <= set(it.trace.span_names())
        assert st.trace.status == "ok"
        assert {"admission", "queue", "dispatch",
                "execute"} <= set(st.trace.span_names())


@in_child
def test_cancel_before_dispatch_terminates_span_tree():
    from repro_torch.runtime.pipeline import TicketCancelled
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    _frozen_broker(svc)
    try:
        t = svc.submit("c0", 4)
        assert t.cancel() is True
        with pytest.raises(TicketCancelled):
            t.result(timeout=1)
    finally:
        svc.stop_pipeline()
    tr = t.trace
    assert tr.status == "cancelled"
    # Complete tree: admission, then the queue wait accounted as the
    # terminal "cancelled" span (it never reached coalesce/dispatch).
    assert tr.span_names() == ["admission", "cancelled"]
    assert tr.span_sum_s() == pytest.approx(tr.duration_s)
    assert tr.duration_s == pytest.approx(
        t.completed_at - t.submitted_at, rel=0.10)
    assert svc.obs.tracer.snapshot()["finished"].get("cancelled", 0) >= 1


@in_child
def test_cancel_in_flight_keeps_cancelled_status():
    from repro_torch.runtime.pipeline import TicketCancelled
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    with svc.start_pipeline(config=_config(
            max_batch=2, batch_sizes=(2,), target_delay_ms=5.0)):
        gate = threading.Event()
        orig = svc.dispatch_group

        def slow_dispatch(requests, tickets):
            gate.set()
            time.sleep(0.15)
            return orig(requests, tickets)

        svc.dispatch_group = slow_dispatch
        try:
            t1 = svc.submit("c0", 4)
            t2 = svc.submit("c0", 4)
            assert gate.wait(timeout=T)
            assert t1.cancel() is True            # races the dispatch
            with pytest.raises(TicketCancelled):
                t1.result(timeout=T)
            t2.result(timeout=T)
        finally:
            svc.dispatch_group = orig
    # The cancel won: terminal status stays "cancelled"; the dispatch's
    # late execute/delivery/ok marks were dropped after termination.
    assert t1.trace.status == "cancelled"
    assert t1.trace.span_names()[-1] == "cancelled"
    assert "delivery" not in t1.trace.span_names()
    assert t2.trace.status == "ok"


@in_child
def test_result_timeout_records_event_then_cancel_terminates():
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    _frozen_broker(svc)
    try:
        t = svc.submit("c0", 4)
        with pytest.raises(TimeoutError):
            t.result(timeout=0.05)
        assert t.trace.live                       # not terminated by expiry
        names = t.trace.span_names()
        assert "result_timeout" in names
        assert t.cancel() is True
    finally:
        svc.stop_pipeline()
    assert t.trace.status == "cancelled"
    assert t.trace.span_names()[-1] == "cancelled"


@in_child
def test_admission_rejection_trace_carries_retry_hint():
    from repro_torch.runtime.pipeline import BrokerSaturated
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    _frozen_broker(svc, max_queue=2)
    try:
        for _ in range(2):
            svc.submit("c0", 4)
        with pytest.raises(BrokerSaturated) as exc:
            svc.submit("c0", 4)
    finally:
        svc.stop_pipeline()
    rejected = svc.obs.tracer.recent(status="rejected")
    assert len(rejected) == 1
    tr = rejected[0]
    assert tr.status == "rejected"
    assert tr.span_names()[0] == "admission"
    assert set(tr.span_names()) <= {"admission", "rejected"}
    admission_meta = tr.to_dict()["spans"][0]["meta"]
    assert admission_meta["rejected"] is True
    assert admission_meta["retry_after_s"] == exc.value.retry_after_s
    assert svc.obs.tracer.snapshot()["finished"]["rejected"] == 1


@in_child
def test_deadline_miss_accounting_per_class():
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)
    with svc.start_pipeline(config=_config(
            max_batch=2, batch_sizes=(2,), target_delay_ms=5.0,
            deadline_classes=(("rush", 0.001), ("lax", 600_000.0)),
            default_class="lax")) as b:
        # Warm, then one group with an impossible budget (must miss) and
        # one with an enormous budget (must not).
        for _ in range(2):
            tks = [svc.submit("c0", 8) for _ in range(2)]
            for t in tks:
                t.result(timeout=T)
        miss = [b.submit("c0", 8, deadline="rush") for _ in range(2)]
        for t in miss:
            t.result(timeout=T)
        hit = [b.submit("c0", 8, deadline="lax") for _ in range(2)]
        for t in hit:
            t.result(timeout=T)
        snap = b.snapshot()["deadline"]
        m = svc.metrics()
    miss_cls, hit_cls = miss[0].deadline_class, hit[0].deadline_class
    assert snap[miss_cls]["missed"] == 2
    assert snap[miss_cls]["fulfilled"] >= 2
    assert snap[hit_cls]["missed"] == 0
    assert snap[hit_cls]["fulfilled"] >= 2
    # The unified snapshot exposes the per-class counts.
    assert m["recoil_deadline_missed_total"]["values"][miss_cls] == 2
    assert m["recoil_deadline_missed_total"]["values"][hit_cls] == 0
    assert m["recoil_deadline_fulfilled_total"]["values"][hit_cls] >= 2


@in_child
def test_profiler_wired_through_sessions_and_executors():
    payloads = _payloads(n_contents=1)
    svc = _service(payloads)                      # ingest -> encode session
    svc.decode("c0", 8)
    svc.decode("c0", 8)                           # warm: run, no resolution
    prof = svc.obs.profiler.snapshot()
    assert prof["decode"]["compiles"] == 1
    assert prof["decode"]["runs"] == 2
    assert prof["decode"]["compile_s"] > 0
    # The encoder has no executable cache: run records only.
    assert prof["encode"]["runs"] == 1
    assert prof["encode"]["compiles"] == 0
    top = prof["decode"]["top"]
    assert top and top[0]["mean_run_ms"] >= 0
    assert svc.session.profiler is svc.obs.profiler
    assert svc._encoder.profiler is svc.obs.profiler
    # Byte accounting: ingested streams are device-resident (no upload);
    # a host registration pays the padded int16 upload exactly once.
    ex = svc.session.executor
    before = (ex.stream_uploads, ex.stream_upload_bytes)
    c = svc.content("c0")
    svc.register("hosted", c.plan,
                 c.stream.words[:c.stream.n_words].numpy().view(np.uint16),
                 c.final_states)
    assert ex.stream_uploads - before[0] == 1
    assert ex.stream_upload_bytes - before[1] == \
        svc.content("hosted").stream.bucket * 2
    snap = svc.metrics()
    assert snap["recoil_engine_stream_uploads_total"]["values"][""] == 1
    assert snap["recoil_profiler_runs_total"]["values"]["encode"] == 1


@in_child
def test_observe_false_disables_instrumentation():
    from repro_torch.runtime.observability import NULL_TRACE
    payloads = _payloads(n_contents=1)
    svc = _service(payloads, observe=False)
    assert svc.obs.profiler is None
    assert svc.session.profiler is None
    assert svc._encoder.profiler is None
    t = svc.submit("c0", 8)
    t.result()
    assert t.trace is NULL_TRACE
    assert svc.submit_stream("c0", 8, 2).trace is NULL_TRACE
    assert svc.obs.tracer.snapshot() == {
        "enabled": False, "capacity": 1024, "started": 0, "retained": 0,
        "finished": {}}
    snap = svc.metrics()
    assert snap["recoil_service_decodes_total"]["values"][""] > 0
    assert "recoil_profiler_runs_total" not in snap


# ----------------------------------------------------------------------
# The metrics schema
# ----------------------------------------------------------------------

@in_child
def test_schema_is_the_references_less_the_left_out_names():
    from repro_torch.runtime.observability import SCHEMA
    assert set(LEFT_OUT) <= set(J_SCHEMA)
    assert set(SCHEMA) == set(J_SCHEMA) - set(LEFT_OUT)
    for name, (mtype, labels) in SCHEMA.items():
        assert (mtype, labels) == J_SCHEMA[name], name


@in_child
def test_metrics_snapshot_is_schema_stable():
    from repro_torch.runtime.faultinject import FaultInjector
    from repro_torch.runtime.observability import SCHEMA
    payloads = _payloads()
    inj = FaultInjector()
    svc = _service(payloads, faults=inj)
    tks = [svc.submit("c0", 8) for _ in range(3)]
    for t in tks:
        t.result()
    svc.submit_stream("c1", 8, n_chunks=3).result()
    inj.arm("service.ingest")
    with pytest.raises(RuntimeError):
        svc.ingest("n2", payloads["c1"], 8)
    snap = svc.metrics()
    text = svc.metrics_text()
    for name, entry in snap.items():
        assert name in SCHEMA, f"uncatalogued metric {name}"
        mtype, labels = SCHEMA[name]
        assert entry["type"] == mtype, name
        assert tuple(entry["labelnames"]) in (tuple(sorted(labels)),
                                              tuple(labels)), name
    assert not set(LEFT_OUT) & set(snap)
    for required in (
            "recoil_service_decodes_total", "recoil_service_ingests_total",
            "recoil_service_stream_requests_total",
            "recoil_engine_executables", "recoil_engine_stream_uploads_total",
            "recoil_profiler_runs_total", "recoil_traces_started_total",
            "recoil_request_latency_ms", "recoil_faults_armed",
            "recoil_faults_fired_total"):
        assert required in snap, required
    assert snap["recoil_service_stream_requests_total"]["values"][""] == 1
    assert snap["recoil_faults_fired_total"]["values"]["service.ingest"] == 1
    assert not [n for n in snap if n.startswith("recoil_broker_")]
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            continue
        head, value = line.rsplit(" ", 1)
        float(value)
        assert head[0].isalpha()
    assert 'recoil_request_latency_ms_bucket{kind="decode",status="ok",' \
        in text
    # With a broker attached (one request held queued, so a lane has
    # depth): every recoil_broker_* name of the reference's schema is
    # yielded, with its type and labels, beside the controller, registry,
    # heat and predictor names.
    b = _frozen_broker(svc)
    try:
        b.submit_ingest("n3", payloads["c1"], 8).result(timeout=T)
        queued = svc.submit("c0", 8)
        snap = svc.metrics()
        text = svc.metrics_text()
    finally:
        svc.stop_pipeline()
    np.testing.assert_array_equal(queued.result(timeout=T).numpy(),
                                  payloads["c0"])
    broker_names = {n for n in J_SCHEMA if n.startswith("recoil_broker_")}
    assert broker_names <= set(snap)
    for name, entry in snap.items():
        assert name in SCHEMA, f"uncatalogued metric {name}"
        assert entry["type"] == SCHEMA[name][0], name
        assert tuple(entry["labelnames"]) in (
            tuple(sorted(SCHEMA[name][1])), tuple(SCHEMA[name][1])), name
    for required in (
            "recoil_registry_memo_hits_total", "recoil_heat_pairs",
            "recoil_controller_lane_rate_hz",
            "recoil_predictor_covered_pairs"):
        assert required in snap, required
    assert snap["recoil_broker_lane_depth"]["values"]["8"] == 1
    assert snap["recoil_broker_submitted_total"]["values"][""] == 1
    assert snap["recoil_broker_ingest_dispatches_total"]["values"][""] == 1
    assert "# TYPE recoil_broker_wait_ms gauge" in text


@in_child
def test_service_metrics_and_traces_match_reference():
    """The same traffic — a batch ingest, a coalesced submit/flush round,
    warm decodes, a stream, a group dispatch and probe, and two injected
    faults — through the reference's service and the port's: every shared
    metric's values are equal (host times aside), the port's encode session
    alone records no compiles (it has no executable cache), and each
    retained trace has the reference's kind, name, status, meta and span
    names and metas, in order."""
    from repro_torch.core import convert
    from repro_torch.runtime.faultinject import FaultInjector
    from repro_torch.runtime.serve import DecodeService, DecodeTicket
    payloads = _payloads()
    jm = JModel.from_symbols(np.concatenate([*payloads.values(),
                                             np.arange(256)]), 256,
                             JParams(n_bits=11, ways=32))
    tm = convert.model_from_arrays(jm.f, jm.F, 11, 32)
    kw = dict(microbatch=2, max_delay_ms=10_000.0)
    jinj, tinj = JInjector(), FaultInjector()
    jsvc = JService(jm, impl="jnp", faults=jinj, **kw)
    tsvc = DecodeService(tm, device="cpu", faults=tinj, **kw)

    def drive(svc, inj, ticket):
        svc.ingest_batch(payloads, 16)
        outs = [svc.submit("c0", 8), svc.submit("c1", 8), svc.submit("c0", 4)]
        svc.flush()
        outs = [np.asarray(t.result()) for t in outs]
        outs += [np.asarray(svc.decode("c1", 8)) for _ in range(2)]
        outs.append(np.asarray(svc.submit_stream("c1", 8, 3).result()))
        group = [("c0", 8), ("c1", 4)]
        tickets = [ticket(svc) for _ in group]
        svc.dispatch_group(group, tickets)
        outs += [np.asarray(t.result()) for t in tickets]
        svc.prepare_group(group)
        inj.arm("service.ingest")
        with pytest.raises(RuntimeError):
            svc.ingest("n2", payloads["c1"], 8)
        inj.arm("service.dispatch_stream")
        with pytest.raises(RuntimeError):
            svc.submit_stream("c0", 8, 2)
        return outs

    for t_out, j_out in zip(drive(tsvc, tinj, DecodeTicket),
                            drive(jsvc, jinj, JTicket), strict=True):
        np.testing.assert_array_equal(t_out, j_out)
    t_snap, j_snap = tsvc.metrics(), jsvc.metrics()
    assert set(t_snap) == set(j_snap) - set(LEFT_OUT)
    j_snap["recoil_profiler_compiles_total"]["values"]["encode"] = 0
    for name in t_snap:
        t_vals, j_vals = t_snap[name]["values"], j_snap[name]["values"]
        if name not in TIMED:
            assert t_vals == j_vals, name
        elif name == "recoil_request_latency_ms":
            assert {k: v["count"] for k, v in t_vals.items()} == \
                {k: v["count"] for k, v in j_vals.items()}, name
        else:
            assert set(t_vals) == set(j_vals), name
    assert t_snap["recoil_service_stream_requests_total"]["values"][""] == 1
    assert t_snap["recoil_traces_finished_total"]["values"] == \
        {"ok": 4, "error": 1}

    def shape(trace):
        d = trace.to_dict()
        return (d["kind"], d["name"], d["status"], d["meta"],
                [(s["span"], s.get("meta")) for s in d["spans"]])

    t_traces, j_traces = tsvc.obs.tracer.recent(), jsvc.obs.tracer.recent()
    assert len(t_traces) == len(j_traces) == 5
    for t_tr, j_tr in zip(t_traces, j_traces):
        assert shape(t_tr) == shape(j_tr)

    # The same services behind a broker that dispatches every request
    # alone, each waited for (deterministic): decodes in three deadline
    # classes, an ingest, a stream and a retried fault.  Every metric —
    # the recoil_broker_* names, the controller's, registry's, heat and
    # deadline names among them — agrees as above, host times aside.
    def drive_broker(svc, inj, cfg_cls):
        cfg = cfg_cls(max_batch=1, batch_sizes=(1,), target_delay_ms=1.0,
                      deadline_classes=(("interactive", 60_000.0),
                                        ("standard", 600_000.0),
                                        ("bulk", 3_600_000.0)))
        b = svc.start_pipeline(config=cfg, predictive=False,
                               retry_backoff_ms=1.0)
        try:
            outs = [np.asarray(svc.submit(n, c, deadline=d).result(
                timeout=T)) for n, c, d in (("c0", 8, None),
                                            ("c1", 4, "interactive"),
                                            ("c0", 4, "bulk"))]
            b.submit_ingest("n3", payloads["c0"], 8).result(timeout=T)
            outs.append(np.asarray(svc.submit("n3", 8).result(timeout=T)))
            st = b.submit_stream("c1", 8, n_chunks=3)
            outs.append(np.concatenate([np.asarray(st.chunk(i, timeout=T))
                                        for i in range(st.n_chunks)]))
            b.drain(timeout=T)
            inj.arm("service.execute", times=1)
            outs.append(np.asarray(svc.submit("c1", 8, retries=1).result(
                timeout=T)))
            b.drain(timeout=T)
            return outs, svc.metrics()
        finally:
            svc.stop_pipeline()

    t_outs, t_snap = drive_broker(tsvc, tinj, _config)
    j_outs, j_snap = drive_broker(jsvc, jinj, JConfig)
    for t_out, j_out in zip(t_outs, j_outs, strict=True):
        np.testing.assert_array_equal(t_out, j_out)
    assert set(t_snap) == set(j_snap) - set(LEFT_OUT)
    assert {n for n in t_snap if n.startswith("recoil_broker_")} == \
        {n for n in J_SCHEMA if n.startswith("recoil_broker_")} - {
            "recoil_broker_lane_depth"}        # no lane holds a request
    j_snap["recoil_profiler_compiles_total"]["values"]["encode"] = 0
    for name in t_snap:
        t_vals, j_vals = t_snap[name]["values"], j_snap[name]["values"]
        if name not in TIMED:
            assert t_vals == j_vals, name
        elif name == "recoil_request_latency_ms":
            assert {k: v["count"] for k, v in t_vals.items()} == \
                {k: v["count"] for k, v in j_vals.items()}, name
        else:
            assert set(t_vals) == set(j_vals), name
    assert t_snap["recoil_broker_retries_total"]["values"][""] == 1
    assert t_snap["recoil_broker_completed_total"]["values"][""] == 6
    assert [shape(tr) for tr in tsvc.obs.tracer.recent()] == \
        [shape(tr) for tr in jsvc.obs.tracer.recent()]
