"""Fault tolerance for 1000+-node runs: preemption, stragglers, elasticity.

The mechanisms are hardware-agnostic (they act on step timings, signals and
checkpoint state), so they are fully exercisable on CPU:

  * :class:`PreemptionGuard` — SIGTERM/SIGINT -> set a flag; the train loop
    checkpoints and exits cleanly at the next step boundary (the standard
    TPU/GCE preemption contract, 30 s notice).
  * :class:`StragglerMonitor` — per-host step-time EMA + z-score; persistent
    stragglers (z > threshold for k consecutive windows) are reported for
    exclusion at the next elastic re-mesh.  At scale this feeds the job
    scheduler; here it feeds tests and logs.
  * :func:`elastic_mesh_shape` — picks the largest (data, model) grid that
    the *surviving* device count supports, preferring to keep the model
    axis (TP degree must divide weight shards) and shrinking data — restore
    then re-shards the logical checkpoint onto the new mesh
    (checkpoint.manager stores no mesh info, so this is just device_put).
  * :func:`run_with_retries` — step wrapper: on transient failure, restore
    from the last checkpoint and replay (idempotent because the data
    pipeline is stateless-by-step).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested


@dataclasses.dataclass
class StragglerReport:
    host: int
    z_score: float
    ema_ms: float
    windows: int


class StragglerMonitor:
    """Tracks per-host step times; flags persistent outliers."""

    def __init__(self, n_hosts: int, alpha: float = 0.2,
                 z_threshold: float = 3.0, windows: int = 3):
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.z_threshold = z_threshold
        self.windows = windows
        self.ema = [None] * n_hosts
        self.strikes = [0] * n_hosts

    def observe(self, step_times_ms) -> list[StragglerReport]:
        import numpy as np
        t = np.asarray(step_times_ms, dtype=np.float64)
        for h in range(self.n_hosts):
            prev = self.ema[h]
            self.ema[h] = t[h] if prev is None else \
                self.alpha * t[h] + (1 - self.alpha) * prev
        emas = np.asarray(self.ema, dtype=np.float64)
        med = np.median(emas)
        # MAD with a relative floor: when all hosts are near-identical the
        # raw MAD degenerates to ~0 and any float noise would z-explode;
        # 5% of median means z=3 <=> ~22% slower than the fleet.
        mad = max(np.median(np.abs(emas - med)), 0.05 * abs(med), 1e-9)
        z = 0.6745 * (emas - med) / mad
        reports = []
        for h in range(self.n_hosts):
            if z[h] > self.z_threshold:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.windows:
                reports.append(StragglerReport(
                    host=h, z_score=float(z[h]), ema_ms=float(emas[h]),
                    windows=self.strikes[h]))
        return reports


def elastic_mesh_shape(n_devices: int, model_parallel: int,
                       pod_size: int = 0) -> tuple:
    """Largest usable (pod, data, model) grid for a surviving device count.

    Keeps the TP degree fixed (weight shard layout), uses whole pods when
    ``pod_size`` is given, and shrinks the data axis to the largest fit.
    Returns (pod, data, model) with pod=1 when pods are not in play.

    Raises ``ValueError`` for any configuration that cannot form a valid
    grid: non-positive counts, fewer devices than the TP degree, or a
    ``pod_size`` that is not a positive multiple of ``model_parallel``
    (a pod smaller than one TP group used to fall through to a data=0
    grid — an invalid mesh that failed far from the cause)."""
    if n_devices <= 0 or model_parallel <= 0:
        raise ValueError(
            f"invalid mesh request: n_devices={n_devices}, "
            f"model_parallel={model_parallel} must both be positive")
    if n_devices < model_parallel:
        raise ValueError("fewer devices than TP degree; cannot re-mesh")
    if pod_size:
        if pod_size < model_parallel or pod_size % model_parallel:
            raise ValueError(
                f"pod_size={pod_size} is not a positive multiple of the "
                f"TP degree {model_parallel} — a whole pod must hold an "
                f"integral number of TP groups")
        pods = n_devices // pod_size
        if pods >= 1:
            return (pods, pod_size // model_parallel, model_parallel)
        # partial pod: fall through to a flat (pod-less) mesh
    return (1, n_devices // model_parallel, model_parallel)


def run_with_retries(step_fn: Callable, restore_fn: Callable,
                     max_retries: int = 3,
                     on_retry: Optional[Callable] = None):
    """Wrap a train step: transient failures -> restore + replay."""

    def wrapped(state, batch):
        for attempt in range(max_retries + 1):
            try:
                return step_fn(state, batch)
            except Exception as e:  # noqa: BLE001 - deliberately broad
                if attempt == max_retries:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                state = restore_fn()
        raise AssertionError("unreachable")

    return wrapped


class StepTimer:
    def __init__(self):
        self.last = None

    def lap_ms(self) -> float:
        now = time.perf_counter()
        out = 0.0 if self.last is None else (now - self.last) * 1e3
        self.last = now
        return out
