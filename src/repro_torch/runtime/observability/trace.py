"""Ticket tracing: one span context per request, threaded end to end.

A :class:`Trace` is a contiguous timeline of *phases* for one ticket's
lifecycle — submit -> admission -> lane queue -> coalesce/fuse -> dispatch
-> executor run -> delivery (decode), plus the ingest/extend/stream/
speculation variants.  Phases are recorded as boundary marks: each
``phase(name, t)`` call closes the interval since the previous boundary and
labels it ``name``, so the recorded spans tile the trace's lifetime with no
gaps or overlaps by construction — the span-sum equals the end-to-end wall
time exactly (the DESIGN.md §13 acceptance invariant).

Terminal states are first-class: ``finish("ok")`` after delivery,
``finish("cancelled")`` from ``PipelineTicket.cancel`` (the open interval
since the last boundary becomes a terminal span named after the status, so
a cancelled-while-queued ticket still accounts for its queue wait),
``finish("rejected")`` on :class:`BrokerSaturated` admission rejection
(``retry_after_s`` lands in the trace meta), and ``finish("error")`` on
dispatch failure.  A ``result(timeout)`` expiry records a zero-width
``result_timeout`` event without closing the trace — the request is still
queued or in flight; the eventual completion (or the caller's follow-up
``cancel()``) terminates it.

Concurrency: a trace's phases are sequential along the request path
(caller thread -> worker thread, ordered by the queue handoff), but
``cancel()``/``result()`` race the workers, so every mutation takes the
per-trace lock.  After ``finish`` wins, late phases from an in-flight
dispatch are dropped silently — the span tree stays terminated exactly
once.  :data:`NULL_TRACE` is the disabled/ticketless no-op stand-in so
instrumentation call sites never branch.

The :class:`TicketTracer` retains finished traces in a bounded ring
(oldest evicted first) and exports them as JSONL — one span tree per line
— for offline waterfall tooling and the CI trace artifact.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import Counter, deque


class NullTrace:
    """No-op span context (tracing disabled, or ticketless filler
    requests).  ``live`` is False so hot paths keyed on an active trace
    (e.g. the fused dispatch's execute-span sync) skip entirely."""

    __slots__ = ()
    live = False
    status = None

    def phase(self, name, t=None, **meta):
        return None

    def event(self, name, t=None, **meta):
        return None

    def finish(self, status="ok", t=None, **meta):
        return None

    def to_dict(self):
        return {}


NULL_TRACE = NullTrace()


class Trace:
    """One ticket's span timeline (see module docstring)."""

    __slots__ = ("trace_id", "kind", "name", "meta", "t0", "t1", "status",
                 "spans", "_last", "_lock", "_tracer")

    def __init__(self, tracer, trace_id: int, kind: str,
                 name: str | None = None, t0: float | None = None,
                 **meta):
        self._tracer = tracer
        self.trace_id = trace_id
        self.kind = kind
        self.name = name
        self.meta = dict(meta)
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self.t1: float | None = None
        self.status: str | None = None
        # (name, start, end, meta_or_None); tiles [t0, t1] by construction.
        self.spans: list[tuple] = []
        self._last = self.t0
        self._lock = threading.Lock()

    @property
    def live(self) -> bool:
        return self.status is None

    @property
    def duration_s(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def span_sum_s(self) -> float:
        with self._lock:
            return sum(t1 - t0 for _, t0, t1, _ in self.spans)

    def span_names(self) -> list[str]:
        with self._lock:
            return [s[0] for s in self.spans]

    def phase(self, name: str, t: float | None = None, **meta):
        """Close the open interval since the previous boundary as a span
        named ``name``.  Dropped silently on a finished trace (a late
        in-flight dispatch racing a cancel).  Runs on every request —
        the body is deliberately minimal."""
        if t is None:
            t = time.perf_counter()
        with self._lock:
            if self.status is not None:
                return
            last = self._last
            if t < last:
                t = last
            self.spans.append((name, last, t, meta or None))
            self._last = t

    def event(self, name: str, t: float | None = None, **meta):
        """Zero-width marker at ``t`` — does NOT advance the phase
        boundary (the surrounding interval still tiles), and unlike
        :meth:`phase` it records on finished traces too (e.g. a
        ``result_timeout`` observed after a cancel already terminated)."""
        t = time.perf_counter() if t is None else float(t)
        with self._lock:
            self.spans.append((name, t, t, meta or None))

    def finish(self, status: str = "ok", t: float | None = None, **meta):
        """Terminate the trace (idempotent — first status wins).  Any open
        interval since the last boundary becomes a terminal span named
        after the status, so e.g. a cancelled-while-queued ticket's queue
        wait is still accounted."""
        t = time.perf_counter() if t is None else float(t)
        with self._lock:
            if self.status is not None:
                return
            if t > self._last + 1e-7:
                self.spans.append((status, self._last, t, None))
                self._last = t
            self.status = status
            self.t1 = self._last
            if meta:
                self.meta.update(meta)
        tracer = self._tracer
        if tracer is not None:
            tracer._retire(self)

    def to_dict(self) -> dict:
        """JSON-ready span tree: the trace is the root, spans its
        children, times in ms relative to the trace start."""
        with self._lock:
            spans = [{"span": n,
                      "start_ms": round((a - self.t0) * 1e3, 4),
                      "dur_ms": round((b - a) * 1e3, 4),
                      **({"meta": m} if m else {})}
                     for n, a, b, m in self.spans]
            return {
                "trace_id": self.trace_id,
                "kind": self.kind,
                "name": self.name,
                "status": self.status,
                "duration_ms": round(self.duration_s * 1e3, 4),
                "meta": dict(self.meta),
                "spans": spans,
            }


class TicketTracer:
    """Bounded ring of finished ticket traces + lifecycle counters.

    ``start()`` is the only way a trace is born; traces retire themselves
    into the ring on ``finish`` (oldest evicted beyond ``capacity``).
    ``on_finish`` hooks (e.g. the metrics registry's request-latency
    histogram) run on the finishing thread — keep them cheap.
    """

    def __init__(self, capacity: int = 1024, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._ids = itertools.count(1)
        self._ring: deque[Trace] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._on_finish: list = []
        self.started = 0
        self.finished: Counter = Counter()

    def start(self, kind: str, name: str | None = None,
              t0: float | None = None, **meta):
        """A new live :class:`Trace` (or :data:`NULL_TRACE` when
        disabled — call sites never branch).  Lock-free: the id counter
        is atomic and ``started`` is the last id handed out, so the
        count stays exact without a lock acquisition per request."""
        if not self.enabled:
            return NULL_TRACE
        tid = next(self._ids)
        self.started = tid
        return Trace(self, tid, kind, name=name, t0=t0, **meta)

    def on_finish(self, hook) -> None:
        """Register ``hook(trace)`` to run when any trace terminates."""
        self._on_finish.append(hook)

    def _retire(self, trace: Trace) -> None:
        with self._lock:
            self.finished[trace.status] += 1
            self._ring.append(trace)
        for hook in self._on_finish:
            hook(trace)

    def recent(self, n: int | None = None, kind: str | None = None,
               status: str | None = None) -> list[Trace]:
        """Most recent finished traces, newest last, optionally filtered."""
        with self._lock:
            traces = list(self._ring)
        if kind is not None:
            traces = [t for t in traces if t.kind == kind]
        if status is not None:
            traces = [t for t in traces if t.status == status]
        return traces if n is None else traces[-n:]

    def export_jsonl(self, path: str) -> int:
        """Write the retained span trees as JSONL (one trace per line,
        oldest first); returns the number written."""
        with self._lock:
            traces = list(self._ring)
        with open(path, "w") as f:
            for t in traces:
                f.write(json.dumps(t.to_dict()) + "\n")
        return len(traces)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "started": self.started,
                "retained": len(self._ring),
                "finished": dict(self.finished),
            }
