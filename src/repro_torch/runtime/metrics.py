"""Step metrics: JSONL logger, throughput/MFU accounting, and the serving
pipeline's latency/overlap instruments.

:class:`LatencyWindow` is a bounded reservoir of per-request latencies with
percentile queries — the broker keeps one for request *wait* (submit →
dispatch) and one for *service* (dispatch → result ready) time.
:class:`OverlapClock` measures how much of one worker's busy time is hidden
under another's (the ingest-vs-decode overlap ratio the async pipeline
exists to maximize, DESIGN.md §8); it is exact interval accounting over
begin/end transitions, not sampling.
:class:`DecayingCounter` is the popularity instrument behind the predictive
serving layer (DESIGN.md §12): an exponentially-decayed event counter whose
value halves every ``half_life_s`` seconds of silence, so "hot" tracks the
recent request distribution instead of all-time totals.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

import numpy as np


class DecayingCounter:
    """Exponentially-decayed event count (half-life semantics).

    ``observe(w)`` adds ``w`` after decaying the stored value by
    ``0.5 ** (elapsed / half_life_s)``; ``value(now)`` reads the decayed
    count without mutating state.  A pair observed ``r`` times per second
    converges to ``r * half_life_s / ln 2`` — heat is proportional to the
    recent arrival rate, and a pair that goes quiet fades instead of
    freezing its busy-period count.  Not internally locked: the
    :class:`~repro_torch.runtime.pipeline.predictor.HeatTracker` that owns a
    population of these serializes access under its own lock.
    """

    __slots__ = ("half_life_s", "_value", "_stamp")

    def __init__(self, half_life_s: float = 30.0):
        if half_life_s <= 0:
            raise ValueError(f"half_life_s must be positive, got {half_life_s}")
        self.half_life_s = float(half_life_s)
        self._value = 0.0
        self._stamp: float | None = None

    def _decayed(self, now: float) -> float:
        if self._stamp is None:
            return 0.0
        return self._value * math.pow(
            0.5, max(now - self._stamp, 0.0) / self.half_life_s)

    def observe(self, weight: float = 1.0, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        self._value = self._decayed(now) + float(weight)
        self._stamp = now
        return self._value

    def value(self, now: float | None = None) -> float:
        return self._decayed(time.perf_counter() if now is None else now)


class LatencyWindow:
    """Bounded ring of latency samples (seconds) with percentile queries.

    The window holds the most recent ``size`` samples, so percentiles track
    current behavior under sustained load instead of averaging over the whole
    run.  Thread-safe BY CONTRACT, not convention: both broker workers (the
    decode dispatcher and the ingest worker) record concurrently, so every
    ring mutation and every read of the ``(buffer, n)`` pair happens under
    the instance lock — ``record``/``reset`` vs ``percentile``/
    ``summary_ms``/``count`` interleavings can never tear a sample or pair a
    stale count with a fresh buffer.
    """

    def __init__(self, size: int = 4096):
        self._buf = np.zeros(size, np.float64)
        self._n = 0          # total samples ever recorded
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = seconds
            self._n += 1

    def reset(self) -> None:
        """Discard all samples (benchmark phase isolation: a suite measures
        its warm phase without the cold phase's tail in the percentiles).
        Stale buffer contents beyond the new count are unreachable —
        ``record`` overwrites from slot 0."""
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def percentile(self, p: float) -> float:
        """p-th percentile (0-100) of the windowed samples, in seconds."""
        with self._lock:
            live = self._buf[:min(self._n, len(self._buf))]
            if live.size == 0:
                return 0.0
            return float(np.percentile(live, p))

    def summary_ms(self) -> dict:
        """{count, p50_ms, p95_ms, p99_ms, mean_ms} over the window."""
        with self._lock:
            live = self._buf[:min(self._n, len(self._buf))].copy()
            n = self._n
        if live.size == 0:
            return {"count": 0, "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                    "mean_ms": 0.0}
        q = np.percentile(live, [50, 95, 99]) * 1e3
        return {"count": n, "p50_ms": float(q[0]), "p95_ms": float(q[1]),
                "p99_ms": float(q[2]), "mean_ms": float(live.mean() * 1e3)}


class OverlapClock:
    """Exact two-worker busy/overlap accounting.

    Workers bracket their busy segments with ``begin(worker)`` /
    ``end(worker)``; the clock accumulates each worker's busy seconds and
    the seconds during which BOTH were busy.  ``ratio()`` is overlapped
    time over the smaller worker's busy time — 1.0 means the cheaper
    worker's entire cost was hidden under the other (perfect overlap),
    0.0 means fully serialized.
    """

    def __init__(self, a: str = "decode", b: str = "ingest"):
        self._names = (a, b)
        self._busy = {a: 0.0, b: 0.0}
        self._since = {a: None, b: None}
        self._both = 0.0
        self._both_since = None
        self._lock = threading.Lock()

    def _other(self, worker: str) -> str:
        return self._names[1] if worker == self._names[0] else self._names[0]

    def begin(self, worker: str) -> float:
        now = time.perf_counter()
        with self._lock:
            self._since[worker] = now
            if self._since[self._other(worker)] is not None:
                self._both_since = now
        return now

    def end(self, worker: str) -> float:
        now = time.perf_counter()
        with self._lock:
            t0 = self._since[worker]
            if t0 is not None:
                self._busy[worker] += now - t0
                self._since[worker] = None
            if self._both_since is not None:
                self._both += now - self._both_since
                self._both_since = None
        return now

    def busy_seconds(self, worker: str) -> float:
        with self._lock:
            return self._busy[worker]

    def ratio(self) -> float:
        with self._lock:
            floor = min(self._busy.values())
            return self._both / floor if floor > 0 else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            floor = min(self._busy.values())
            return {
                f"{name}_busy_s": round(self._busy[name], 4)
                for name in self._names
            } | {"overlap_s": round(self._both, 4),
                 "overlap_ratio": round(self._both / floor, 4)
                 if floor > 0 else 0.0}


class MetricsLogger:
    def __init__(self, path: str | None = None, print_every: int = 10):
        self.path = path
        self.print_every = print_every
        self._fh = open(path, "a") if path else None
        self._t0 = time.perf_counter()

    def log(self, step: int, metrics: dict, tokens_per_step: int = 0,
            peak_flops_per_s: float = 0.0, model_flops_per_token: float = 0.0):
        rec = {"step": step, "wall_s": time.perf_counter() - self._t0}
        rec.update({k: float(v) for k, v in metrics.items()})
        if tokens_per_step:
            dt = rec["wall_s"] / max(step + 1, 1)
            rec["tokens_per_s"] = tokens_per_step / dt
            if peak_flops_per_s and model_flops_per_token:
                rec["mfu"] = (rec["tokens_per_s"] * model_flops_per_token
                              / peak_flops_per_s)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if step % self.print_every == 0:
            msg = "  ".join(f"{k}={v:.4g}" for k, v in rec.items()
                            if k != "wall_s")
            print(f"[metrics] {msg}", flush=True)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
