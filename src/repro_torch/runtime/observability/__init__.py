"""Unified observability for the serving stack (the port's fork).

One :class:`Observability` object per :class:`~repro_torch.runtime.serve
.DecodeService` bundles the three instruments this package provides:

  * :class:`~repro_torch.runtime.observability.trace.TicketTracer` —
    per-ticket span timelines threaded through submit -> admission ->
    queue -> coalesce -> dispatch -> execute -> delivery (and the stream
    path), bounded ring + JSONL export;
  * :class:`~repro_torch.runtime.observability.registry.MetricsRegistry` —
    the one scrape surface: native instruments (request-latency histogram)
    plus pull collectors that absorb ``ServiceStats``, the engine's
    launcher and upload counts, the profiler, the tracer, the fault
    injector and, while a pipeline runs, the broker's depths and counters,
    the capability registry, the prethinner, the controller's EMAs and the
    per-class deadline accounting;
  * :class:`~repro_torch.runtime.observability.profiler.ExecProfiler` —
    per-plan-key launcher-resolution/run timing shared by the decode and
    encode sessions.

``trace``, ``registry`` and ``profiler`` are the JAX package's modules,
copied.  This module is forked: its collectors read the port's service and
executor, and ``SCHEMA`` leaves out the reference's names whose source the
port does not have (it never emits them as constant zeros):

  * ``recoil_service_encode_compiles_total`` and
    ``recoil_service_encode_fallbacks_total`` — the ingest kernels take
    their sizes at run time, so the encoder has no executable cache and no
    fast/full tier;
  * ``recoil_service_host_materializations_total`` and
    ``recoil_engine_host_materialized_bytes_total`` — streams stay on the
    card; no executor copies them to the host;
  * ``recoil_engine_policy_info`` — its ``policy`` label names a bucket
    policy, and the port has none.

Every other name keeps the reference's type and labels.  The broker
collector is the reference's: it yields every ``recoil_broker_*`` name (and
the controller, registry, heat, predictor and deadline names) while a
pipeline broker is attached, and nothing otherwise.

Everything here is duck-typed over the service/broker surfaces — the
package imports nothing from ``runtime.serve`` or ``runtime.pipeline``
(they import *us*), keeping the layering acyclic.
"""

from __future__ import annotations

from .profiler import ExecProfiler
from .registry import MetricsRegistry
from .trace import NULL_TRACE, NullTrace, TicketTracer, Trace

__all__ = [
    "ExecProfiler", "MetricsRegistry", "NULL_TRACE", "NullTrace",
    "Observability", "SCHEMA", "TicketTracer", "Trace", "waterfall",
]


# Every metric name the stack can emit: name -> (type, label keys).  The
# snapshot at any moment exposes a SUBSET (collector samples appear once
# their source exists — e.g. broker metrics only while a pipeline runs);
# the schema test asserts subset-ness AND exact type/label agreement.
SCHEMA = {
    # DecodeService counters (ServiceStats)
    "recoil_service_compiles_total": ("counter", ()),
    "recoil_service_cache_hits_total": ("counter", ()),
    "recoil_service_decodes_total": ("counter", ()),
    "recoil_service_plan_hits_total": ("counter", ()),
    "recoil_service_plan_misses_total": ("counter", ()),
    "recoil_service_coalesced_requests_total": ("counter", ()),
    "recoil_service_fused_dispatches_total": ("counter", ()),
    "recoil_service_flushes_total": ("counter", ()),
    "recoil_service_ingests_total": ("counter", ()),
    "recoil_service_extends_total": ("counter", ()),
    "recoil_service_stream_requests_total": ("counter", ()),
    "recoil_service_plan_layout_total": ("counter", ("layout",)),
    # Engine / executor accounting
    "recoil_engine_executables": ("gauge", ()),
    "recoil_engine_stream_uploads_total": ("counter", ()),
    "recoil_engine_stream_upload_bytes_total": ("counter", ()),
    # Per-plan-key profiler rollups
    "recoil_profiler_compiles_total": ("counter", ("session",)),
    "recoil_profiler_compile_seconds_total": ("counter", ("session",)),
    "recoil_profiler_runs_total": ("counter", ("session",)),
    "recoil_profiler_run_seconds_total": ("counter", ("session",)),
    # Tracer lifecycle
    "recoil_traces_started_total": ("counter", ()),
    "recoil_traces_finished_total": ("counter", ("status",)),
    "recoil_traces_retained": ("gauge", ()),
    # Native request-latency histogram (fed on trace finish)
    "recoil_request_latency_ms": ("histogram", ("kind", "status")),
    # Pipeline broker (present while a pipeline runs)
    "recoil_broker_queue_depth": ("gauge", ()),
    "recoil_broker_ingest_queue_depth": ("gauge", ()),
    "recoil_broker_lane_depth": ("gauge", ("lane",)),
    "recoil_broker_submitted_total": ("counter", ()),
    "recoil_broker_completed_total": ("counter", ()),
    "recoil_broker_rejected_total": ("counter", ()),
    "recoil_broker_cancelled_total": ("counter", ()),
    "recoil_broker_dispatch_groups_total": ("counter", ()),
    "recoil_broker_dispatch_errors_total": ("counter", ()),
    "recoil_broker_ingest_events_total": ("counter", ()),
    "recoil_broker_ingest_dispatches_total": ("counter", ()),
    "recoil_broker_ingest_errors_total": ("counter", ()),
    "recoil_broker_extend_events_total": ("counter", ()),
    "recoil_broker_stream_dispatches_total": ("counter", ()),
    # Reliability (DESIGN.md §14: supervision, retry, quarantine, degrade)
    "recoil_broker_worker_restarts_total": ("counter", ()),
    "recoil_broker_retries_total": ("counter", ()),
    "recoil_broker_quarantined_total": ("counter", ()),
    "recoil_broker_quarantine_rejects_total": ("counter", ()),
    "recoil_broker_degraded_dispatches_total": ("counter", ()),
    "recoil_broker_retry_queue_depth": ("gauge", ()),
    "recoil_broker_quarantined_contents": ("gauge", ()),
    "recoil_broker_degraded_lanes": ("gauge", ()),
    "recoil_faults_armed": ("gauge", ()),
    "recoil_faults_fired_total": ("counter", ("site",)),
    "recoil_broker_wait_ms": ("gauge", ("stat",)),
    "recoil_broker_service_ms": ("gauge", ("stat",)),
    "recoil_broker_ingest_service_ms": ("gauge", ("stat",)),
    "recoil_broker_overlap_ratio": ("gauge", ()),
    # Adaptive controller EMAs
    "recoil_controller_lane_rate_hz": ("gauge", ("lane",)),
    "recoil_controller_service_ms": ("gauge", ("batch",)),
    # Capability registry
    "recoil_registry_memo_hits_total": ("counter", ()),
    "recoil_registry_memo_misses_total": ("counter", ()),
    "recoil_registry_speculative_hits_total": ("counter", ()),
    "recoil_registry_prethins_total": ("counter", ()),
    "recoil_registry_evictions_total": ("counter", ()),
    "recoil_registry_plans_cached": ("gauge", ()),
    "recoil_registry_containers_cached": ("gauge", ()),
    # Predictive serving
    "recoil_heat_pairs": ("gauge", ()),
    "recoil_heat_observations_total": ("counter", ()),
    "recoil_predictor_covered_pairs": ("gauge", ()),
    "recoil_predictor_warmed_shapes": ("gauge", ()),
    "recoil_predictor_prethins_total": ("counter", ()),
    "recoil_predictor_warm_probes_total": ("counter", ()),
    "recoil_predictor_warm_compiles_total": ("counter", ()),
    "recoil_predictor_evictions_total": ("counter", ()),
    # Deadline SLO accounting (per class, ROADMAP follow-up)
    "recoil_deadline_fulfilled_total": ("counter", ("class",)),
    "recoil_deadline_missed_total": ("counter", ("class",)),
}


def _c(name, value, labels=None):
    s = {"name": name, "type": SCHEMA[name][0], "value": value}
    if labels:
        s["labels"] = labels
    return s


class Observability:
    """Per-service tracer + registry + profiler bundle.

    ``enabled=False`` is the zero-overhead configuration the CI overhead
    guard compares against: the tracer hands out :data:`NULL_TRACE`, the
    profiler is None (sessions skip their timing branches), and only the
    pull collectors remain (they cost nothing until scraped).
    """

    def __init__(self, enabled: bool = True, trace_capacity: int = 1024):
        self.enabled = bool(enabled)
        self.tracer = TicketTracer(capacity=trace_capacity, enabled=enabled)
        self.registry = MetricsRegistry()
        self.profiler = ExecProfiler() if enabled else None
        self._latency = self.registry.histogram(
            "recoil_request_latency_ms",
            "end-to-end request latency by ticket kind and terminal status",
            labelnames=("kind", "status"))
        # Child handles cached per (kind, status): the finish hook runs on
        # every request, and label resolution per call would dominate it.
        self._lat_children: dict = {}
        self.tracer.on_finish(self._observe_latency)

    def _observe_latency(self, trace) -> None:
        key = (trace.kind, trace.status)
        child = self._lat_children.get(key)
        if child is None:
            child = self._lat_children[key] = self._latency.labels(
                kind=trace.kind, status=trace.status)
        child.observe(trace.duration_s * 1e3)

    # ------------------------------------------------------------------
    # Service wiring
    # ------------------------------------------------------------------

    def attach_service(self, svc) -> None:
        """Register the pull collectors over a DecodeService (and, when one
        is attached at scrape time, its pipeline broker)."""
        self.registry.register_collector(lambda: _service_samples(svc))
        self.registry.register_collector(lambda: _engine_samples(svc))
        self.registry.register_collector(lambda: _profiler_samples(self))
        self.registry.register_collector(lambda: _tracer_samples(self))
        self.registry.register_collector(lambda: _broker_samples(svc))
        self.registry.register_collector(lambda: _fault_samples(svc))

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def exposition(self) -> str:
        return self.registry.exposition()


# ---------------------------------------------------------------------------
# Collectors (pull; sampled only at snapshot/exposition time)
# ---------------------------------------------------------------------------

_SERVICE_FIELDS = (
    "compiles", "cache_hits", "decodes", "plan_hits", "plan_misses",
    "coalesced_requests", "fused_dispatches", "flushes", "ingests",
    "extends", "stream_requests")


def _service_samples(svc) -> list[dict]:
    st = svc.stats.snapshot()
    out = [_c(f"recoil_service_{f}_total", st[f]) for f in _SERVICE_FIELDS]
    out.append(_c("recoil_service_plan_layout_total", st["symbol_plans"],
                  {"layout": "symbol"}))
    out.append(_c("recoil_service_plan_layout_total", st["pointer_plans"],
                  {"layout": "pointer"}))
    return out


def _engine_samples(svc) -> list[dict]:
    sess = svc.session
    ex = sess.executor
    return [
        _c("recoil_engine_executables", sess.executables),
        _c("recoil_engine_stream_uploads_total",
           getattr(ex, "stream_uploads", 0)),
        _c("recoil_engine_stream_upload_bytes_total",
           getattr(ex, "stream_upload_bytes", 0)),
    ]


def _profiler_samples(obs: Observability) -> list[dict]:
    if obs.profiler is None:
        return []
    out = []
    for session in ("decode", "encode"):
        t = obs.profiler.totals(session)
        out += [
            _c("recoil_profiler_compiles_total", t["compiles"],
               {"session": session}),
            _c("recoil_profiler_compile_seconds_total",
               round(t["compile_s"], 6), {"session": session}),
            _c("recoil_profiler_runs_total", t["runs"],
               {"session": session}),
            _c("recoil_profiler_run_seconds_total",
               round(t["run_s"], 6), {"session": session}),
        ]
    return out


def _tracer_samples(obs: Observability) -> list[dict]:
    t = obs.tracer.snapshot()
    out = [
        _c("recoil_traces_started_total", t["started"]),
        _c("recoil_traces_retained", t["retained"]),
    ]
    for status, n in sorted(t["finished"].items()):
        out.append(_c("recoil_traces_finished_total", n,
                      {"status": status}))
    return out


_BROKER_COUNTERS = (
    "submitted", "completed", "rejected", "cancelled", "dispatch_groups",
    "dispatch_errors", "ingest_events", "ingest_dispatches",
    "ingest_errors", "extend_events", "stream_dispatches",
    "worker_restarts", "retries", "quarantine_rejects",
    "degraded_dispatches")

_WINDOW_STATS = ("p50_ms", "p95_ms", "p99_ms", "mean_ms")


def _window(name: str, summary: dict) -> list[dict]:
    return [_c(name, round(summary[s], 4), {"stat": s.removesuffix("_ms")})
            for s in _WINDOW_STATS]


def _broker_samples(svc) -> list[dict]:
    broker = getattr(svc, "broker", None)
    if broker is None:
        return []
    s = broker.snapshot()
    out = [
        _c("recoil_broker_queue_depth", s["queue_depth"]),
        _c("recoil_broker_ingest_queue_depth", s["ingest_queue_depth"]),
        _c("recoil_broker_overlap_ratio", s["overlap"]["overlap_ratio"]),
    ]
    out += [_c(f"recoil_broker_{f}_total", s[f]) for f in _BROKER_COUNTERS]
    out += [_c("recoil_broker_lane_depth", d, {"lane": lane})
            for lane, d in s["lanes"].items()]
    out += _window("recoil_broker_wait_ms", s["wait"])
    out += _window("recoil_broker_service_ms", s["service"])
    out += _window("recoil_broker_ingest_service_ms", s["ingest_service"])
    ctl = s["controller"]
    out += [_c("recoil_controller_lane_rate_hz", r, {"lane": lane})
            for lane, r in ctl["lanes"].items()]
    out += [_c("recoil_controller_service_ms", ms, {"batch": b})
            for b, ms in ctl["service_ms"].items()]
    reg = s["registry"]
    out += [
        _c("recoil_registry_memo_hits_total", reg["memo_hits"]),
        _c("recoil_registry_memo_misses_total", reg["memo_misses"]),
        _c("recoil_registry_speculative_hits_total",
           reg["speculative_hits"]),
        _c("recoil_registry_prethins_total", reg["prethins"]),
        _c("recoil_registry_evictions_total", reg["evictions"]),
        _c("recoil_registry_plans_cached", reg["plans_cached"]),
        _c("recoil_registry_containers_cached", reg["containers_cached"]),
        _c("recoil_heat_pairs", s["heat"]["pairs"]),
        _c("recoil_heat_observations_total", s["heat"]["observations"]),
    ]
    pred = s["predictive"]
    if pred is not None:
        out += [
            _c("recoil_predictor_covered_pairs", pred["covered_pairs"]),
            _c("recoil_predictor_warmed_shapes", pred["warmed_shapes"]),
            _c("recoil_predictor_prethins_total", pred["prethins"]),
            _c("recoil_predictor_warm_probes_total", pred["warm_probes"]),
            _c("recoil_predictor_warm_compiles_total",
               pred["warm_compiles"]),
            _c("recoil_predictor_evictions_total", pred["evictions"]),
        ]
    rel = s["reliability"]
    out += [
        _c("recoil_broker_quarantined_total", rel["quarantined"]),
        _c("recoil_broker_retry_queue_depth", rel["retry_queue_depth"]),
        _c("recoil_broker_quarantined_contents",
           len(rel["quarantined_contents"])),
        _c("recoil_broker_degraded_lanes", len(rel["degraded_lanes"])),
    ]
    for cls, d in sorted(s.get("deadline", {}).items()):
        out.append(_c("recoil_deadline_fulfilled_total", d["fulfilled"],
                      {"class": cls}))
        out.append(_c("recoil_deadline_missed_total", d["missed"],
                      {"class": cls}))
    return out


def _fault_samples(svc) -> list[dict]:
    """Fault-injector visibility (reliability suite/bench runs; the no-op
    production injector reports an empty armed set and no firings)."""
    faults = getattr(svc, "faults", None)
    if faults is None:
        return []
    snap = faults.snapshot()
    out = [_c("recoil_faults_armed", len(snap["armed"]))]
    out += [_c("recoil_faults_fired_total", n, {"site": site})
            for site, n in sorted(snap["fired"].items())]
    return out


# ---------------------------------------------------------------------------
# Presentation helper (examples / debugging)
# ---------------------------------------------------------------------------

def waterfall(trace, width: int = 48) -> str:
    """ASCII span waterfall for one finished trace — one bar-scaled line
    per span (the ``observability_demo`` rendering)."""
    d = trace.to_dict() if hasattr(trace, "to_dict") else dict(trace)
    total = max(d.get("duration_ms", 0.0), 1e-9)
    head = (f"trace #{d['trace_id']} {d['kind']}:{d.get('name')} "
            f"[{d['status']}] {d['duration_ms']:.3f} ms")
    lines = [head]
    for s in d.get("spans", []):
        lo = int(round(s["start_ms"] / total * width))
        ln = max(int(round(s["dur_ms"] / total * width)), 1)
        bar = " " * min(lo, width - 1) + "#" * min(ln, width - lo)
        lines.append(f"  {s['span']:<14} |{bar:<{width}}| "
                     f"{s['dur_ms']:8.3f} ms")
    return "\n".join(lines)
