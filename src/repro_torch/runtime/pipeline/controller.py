"""Adaptive microbatch controller: flush policy from arrival-rate stats.

The synchronous ``DecodeService`` flush policy is static — a fixed
``microbatch`` size and a fixed ``max_delay_ms``.  Under light traffic the
static size strands requests until the delay bound; under heavy traffic it
flushes smaller groups than the queue could supply.  The controller closes
the loop (ROADMAP: "adaptive microbatch sizing from arrival-rate stats"):

  * **Arrival rate** — an EMA over inter-arrival gaps, one estimate per
    capability lane (lanes see very different rates under heterogeneous
    client mixes).  The EMA also decays against the *elapsed* gap since the
    last arrival, so a lane that goes quiet converges to "slow" instead of
    freezing its last busy-period estimate.
  * **Service time** — an EMA of fused-dispatch wall time per quantized
    batch size, recorded by the broker after every dispatch.
  * **Decision** — the classic batching fixpoint: while a batch of size B
    decodes (``s(B)`` seconds), ``lam * s(B)`` new requests arrive; the
    target batch is the smallest quantized size >= that product, clamped to
    ``[1, max_batch]``.  A lane flushes when it holds the target count, or
    when its oldest request has waited ``target_delay_ms`` (latency floor —
    the delay bound is obeyed regardless of the rate estimate).

**Batch sizes are quantized** (default powers of two up to ``max_batch``).
This is not a tuning nicety but what keeps the steady state compile-free:
the fused executable's cache key depends on the bucketed split-row count /
output size of the group, so free-running batch sizes would mint fresh
buckets under load.  Quantized sizes (x uniform-capability lanes, see
``broker.py``) give a small closed set of group shapes that warmup can
enumerate — the bench's 0-recompile guard relies on it.

**Deadline classes** (DESIGN.md §12) refine the flat ``target_delay_ms``
floor: each decode ticket carries a latency *budget* resolved from its
class (``interactive`` / ``standard`` / ``bulk`` by default, overridable
via ``deadline_classes``), and a lane dispatches a partial group as soon
as the most urgent queued ticket's budget nears exhaustion
(``deadline_margin_ms`` before ``deadline_at``).  Bulk lanes therefore
accumulate past the old flat floor into larger, cheaper groups while
interactive tickets still flush in time — the broker feeds ``decide`` the
lane's minimum remaining slack and the old ``oldest_wait_ms`` path remains
for callers without deadlines.

The controller is pure bookkeeping — no threads, no jax — so it is unit
testable with synthetic clocks (``tests/test_pipeline.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    max_batch: int = 8
    batch_sizes: tuple = ()          # () -> powers of two up to max_batch
    target_delay_ms: float = 25.0    # latency floor: oldest wait forces flush
    ema_alpha: float = 0.25          # arrival/service estimator gain
    default_service_ms: float = 5.0  # prior before the first observation
    # ((class_name, budget_ms), ...); () -> interactive/standard/bulk
    # derived from target_delay_ms (standard == the legacy flat floor).
    deadline_classes: tuple = ()
    default_class: str = "standard"
    deadline_margin_ms: float = 5.0  # dispatch this early vs. the deadline

    def sizes(self) -> tuple:
        if self.batch_sizes:
            return tuple(sorted(set(self.batch_sizes)))
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return tuple(sorted(set(out)))

    def classes(self) -> dict:
        """Deadline-class budgets in ms.  ``standard`` keeps the legacy
        flat-floor behavior; ``interactive`` flushes 4x sooner; ``bulk``
        may wait 8x longer and so forms larger (cheaper) groups."""
        if self.deadline_classes:
            return dict(self.deadline_classes)
        t = self.target_delay_ms
        return {"interactive": max(t / 4.0, 1.0), "standard": t,
                "bulk": t * 8.0}


@dataclasses.dataclass
class _LaneEstimate:
    rate_hz: float = 0.0        # EMA arrival rate
    last_arrival: float | None = None


@dataclasses.dataclass(frozen=True)
class FlushDecision:
    dispatch: bool       # form a group now?
    batch: int           # quantized group size to take when dispatching
    wait_more_ms: float  # if not dispatching: re-check deadline from now


class AdaptiveController:
    """Per-lane EMA arrival estimator + per-size service estimator -> flush
    decisions.  One instance per broker; all methods are cheap and called
    under the broker's queue lock."""

    def __init__(self, cfg: ControllerConfig | None = None):
        self.cfg = cfg or ControllerConfig()
        self._sizes = self.cfg.sizes()
        self._lanes: dict = {}
        # service-time EMA per quantized batch size (seconds)
        self._service_s: dict[int, float] = {}

    # ------------------------------------------------------------------
    # Observations
    # ------------------------------------------------------------------

    def observe_arrival(self, lane, now: float) -> None:
        est = self._lanes.get(lane)
        if est is None:
            est = self._lanes[lane] = _LaneEstimate()
        if est.last_arrival is not None:
            gap = max(now - est.last_arrival, 1e-6)
            a = self.cfg.ema_alpha
            est.rate_hz = (1 - a) * est.rate_hz + a / gap
        est.last_arrival = now

    def observe_service(self, batch: int, seconds: float) -> None:
        b = self.quantize(batch)
        a = self.cfg.ema_alpha
        prev = self._service_s.get(b)
        self._service_s[b] = (seconds if prev is None
                              else (1 - a) * prev + a * seconds)

    # ------------------------------------------------------------------
    # Decisions
    # ------------------------------------------------------------------

    def quantize(self, n: int) -> int:
        """Smallest quantized batch size >= n (clamped to max_batch)."""
        for b in self._sizes:
            if b >= n:
                return b
        return self._sizes[-1]

    def rate_hz(self, lane, now: float) -> float:
        """Current arrival-rate estimate, decayed by the open gap since the
        last arrival (a quiet lane slows down instead of freezing)."""
        est = self._lanes.get(lane)
        if est is None or est.last_arrival is None:
            return 0.0
        open_gap = max(now - est.last_arrival, 1e-6)
        # the open gap lower-bounds the next inter-arrival sample
        return min(est.rate_hz, 1.0 / open_gap) if open_gap > 1e-3 \
            else est.rate_hz

    def service_s(self, batch: int) -> float:
        return self._service_s.get(self.quantize(batch),
                                   self.cfg.default_service_ms * 1e-3)

    def target_batch(self, lane, now: float) -> int:
        """Batching fixpoint: smallest quantized B with B >= lam * s(B)."""
        lam = self.rate_hz(lane, now)
        for b in self._sizes:
            if b >= lam * self.service_s(b):
                return b
        return self._sizes[-1]

    def budget_ms(self, deadline=None) -> tuple[str, float]:
        """Resolve a submit-time deadline into ``(class_name, budget_ms)``.

        ``deadline`` may be None (the config's default class), a class name
        from :meth:`ControllerConfig.classes`, or an explicit budget in ms.
        Unknown class names raise loudly — a typo'd class silently falling
        back to ``standard`` would be an SLO bug, not a convenience.
        """
        classes = self.cfg.classes()
        if deadline is None:
            deadline = self.cfg.default_class
        if isinstance(deadline, str):
            if deadline not in classes:
                raise KeyError(
                    f"unknown deadline class {deadline!r}; "
                    f"configured: {sorted(classes)}")
            return deadline, float(classes[deadline])
        budget = float(deadline)
        if budget <= 0:
            raise ValueError(f"deadline budget must be positive, got {budget}")
        return "custom", budget

    def decide(self, lane, queued: int, oldest_wait_ms: float,
               now: float, flush_slack_ms: float | None = None
               ) -> FlushDecision:
        """Flush policy for one lane (see module docstring).

        ``flush_slack_ms`` is the lane's minimum remaining slack before a
        queued ticket's deadline (margin already subtracted by the broker at
        submit time).  When provided it REPLACES the flat ``target_delay_ms``
        floor: the lane dispatches a partial group once slack runs out,
        which lets bulk tickets accumulate past the flat floor and forces
        interactive tickets out early.  Callers without deadlines (``None``)
        keep the legacy oldest-wait behavior.
        """
        if queued <= 0:
            return FlushDecision(False, 0, self.cfg.target_delay_ms)
        target = self.target_batch(lane, now)
        if queued >= target or queued >= self.cfg.max_batch:
            return FlushDecision(True, min(queued, self.cfg.max_batch), 0.0)
        if flush_slack_ms is not None:
            if flush_slack_ms <= 0.0:
                return FlushDecision(True, queued, 0.0)
            return FlushDecision(False, target, flush_slack_ms)
        if oldest_wait_ms >= self.cfg.target_delay_ms:
            return FlushDecision(True, queued, 0.0)
        return FlushDecision(
            False, target, self.cfg.target_delay_ms - oldest_wait_ms)

    def snapshot(self) -> dict:
        return {
            "lanes": {
                str(lane): round(est.rate_hz, 2)
                for lane, est in self._lanes.items()},
            "service_ms": {
                b: round(s * 1e3, 3) for b, s in self._service_s.items()},
            "batch_sizes": list(self._sizes),
            "deadline_classes": {
                k: round(v, 3) for k, v in self.cfg.classes().items()},
        }
