"""Executor profiling: per-plan-key compile-vs-execute timing (DESIGN §13).

The decode and encode sessions already count compiles/hits exactly; what
they could not answer is *where the time went* — which plan keys paid
compilation, what a warm dispatch of each shape costs, and how the mix
splits between layouts and policies.  :class:`ExecProfiler` is that one
instrument: sessions call ``record_compile``/``record_run`` around
``executor.lower``/``executor.run`` (a perf_counter pair and one locked
dict update per dispatch — cheap enough to stay always-on), and the bench
suites/tuner read ``snapshot()`` instead of re-deriving ad-hoc timers.

``record_run`` times the *dispatch call*: on asynchronous backends the XLA
execution may still be in flight when it returns, so run times are a
host-side dispatch cost unless the caller syncs (the service's traced
fused path does, so its per-key run times are true device walls).

The profiler is injected, not imported, by ``core`` sessions (they take a
``profiler=`` duck — keeping the core -> runtime layering clean); the
:class:`~repro_torch.runtime.observability.Observability` owner shares one
instance between the decode and encode sessions of a service, with the
``session`` dimension ("decode"/"encode") separating them.

Key population is bounded (``max_keys`` per session kind): a pathological
plan-key churn aggregates into the ``"<overflow>"`` row instead of growing
the dict forever.
"""

from __future__ import annotations

import threading
import time


class _KeyStats:
    __slots__ = ("compiles", "compile_s", "runs", "run_s")

    def __init__(self):
        self.compiles = 0
        self.compile_s = 0.0
        self.runs = 0
        self.run_s = 0.0


class ExecProfiler:
    """Per-(session, plan-key) compile/run accounting (module docstring)."""

    OVERFLOW = "<overflow>"

    def __init__(self, enabled: bool = True, max_keys: int = 512):
        self.enabled = bool(enabled)
        self.max_keys = int(max_keys)
        self._lock = threading.Lock()
        # session kind ("decode"/"encode") -> {key_str: _KeyStats}
        self._keys: dict[str, dict[str, _KeyStats]] = {}

    # ------------------------------------------------------------------
    # Hot-path recording (sessions call these)
    # ------------------------------------------------------------------

    def now(self) -> float:
        return time.perf_counter()

    def _stats(self, session: str, key) -> _KeyStats:
        """Caller holds ``_lock``.  Keys are stored natively (plan keys
        are hashable tuples) — stringifying on the hot path would cost
        more than the rest of the record combined; ``snapshot()`` renders
        them for JSON."""
        table = self._keys.setdefault(session, {})
        st = table.get(key)
        if st is None:
            if len(table) >= self.max_keys:
                key = self.OVERFLOW
                st = table.get(key)
                if st is None:
                    st = table[key] = _KeyStats()
            else:
                st = table[key] = _KeyStats()
        return st

    def record_compile(self, session: str, key, seconds: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            st = self._stats(session, key)
            st.compiles += 1
            st.compile_s += seconds

    def record_run(self, session: str, key, seconds: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            st = self._stats(session, key)
            st.runs += 1
            st.run_s += seconds

    # ------------------------------------------------------------------
    # Read surfaces
    # ------------------------------------------------------------------

    def totals(self, session: str) -> dict:
        with self._lock:
            table = self._keys.get(session, {})
            return {
                "keys": len(table),
                "compiles": sum(s.compiles for s in table.values()),
                "compile_s": sum(s.compile_s for s in table.values()),
                "runs": sum(s.runs for s in table.values()),
                "run_s": sum(s.run_s for s in table.values()),
            }

    def snapshot(self, top: int = 8) -> dict:
        """Per-session totals + the ``top`` keys by total time, each with
        compile/run counts, seconds, and mean warm-run ms."""
        out = {"enabled": self.enabled}
        with self._lock:
            sessions = {k: dict(v) for k, v in self._keys.items()}
        for session, table in sessions.items():
            rows = sorted(
                table.items(),
                key=lambda kv: -(kv[1].compile_s + kv[1].run_s))[:top]
            out[session] = {
                "keys": len(table),
                "compiles": sum(s.compiles for s in table.values()),
                "compile_s": round(
                    sum(s.compile_s for s in table.values()), 6),
                "runs": sum(s.runs for s in table.values()),
                "run_s": round(sum(s.run_s for s in table.values()), 6),
                "top": [{
                    "key": str(k),
                    "compiles": s.compiles,
                    "compile_ms": round(s.compile_s * 1e3, 3),
                    "runs": s.runs,
                    "run_ms": round(s.run_s * 1e3, 3),
                    "mean_run_ms": round(
                        s.run_s / s.runs * 1e3, 4) if s.runs else 0.0,
                } for k, s in rows],
            }
        return out
