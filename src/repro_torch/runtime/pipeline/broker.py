"""Async request broker: overlapped ingest+decode with capability lanes.

The synchronous ``DecodeService`` serves from the caller's thread: an
``ingest`` blocks every decode behind the encode kernels, and flush policy
is static.  The broker is the serving control plane in front of the engine
tiers (the JAX package's DESIGN.md §8):

  * **Two worker threads** — a decode dispatcher and an ingest worker,
    both on the service's device.  Each launches on that device's default
    CUDA stream (a new thread starts on it), so the card runs ingest and
    decode kernels in the order the two threads enqueue them; what
    overlaps is host work — the ingest's host half (reads of sizes and
    split metadata, Python) against the decode worker's enqueues and
    waits.  :class:`~repro_torch.runtime.metrics.OverlapClock` measures
    the achieved overlap of the two workers' busy intervals exactly.
  * **Capability lanes** — pending decode requests queue per declared
    ``n_threads``.  Groups are formed within one lane: the fused walk runs
    ``max(n_steps)`` steps for *every* row, so coalescing a 1-thread
    client (long walks) with a 64-thread client (short walks) would make
    the fast client pay the slow client's step count.  Uniform-capability
    groups also keep the fused-bucket set small enough to resolve every
    launcher ahead of traffic (see ``controller.py`` on why that matters
    for a steady state that resolves none).
  * **Adaptive flush** — the
    :class:`~repro_torch.runtime.pipeline.controller.AdaptiveController`
    decides
    per tick, from EMA arrival-rate and service-time estimates, how large a
    group to form and how long a partial group may wait.
  * **Admission control** — a bounded total queue AND a per-lane depth
    bound; a saturated broker rejects with :class:`BrokerSaturated`
    carrying a ``retry_after_s`` hint derived from the controller's EMA
    service times (how long the rejected lane needs to drain), instead of
    queueing unboundedly.
  * **Deadline-aware flush** — each decode ticket carries a deadline class
    (``interactive``/``standard``/``bulk``, controller.py); a lane
    dispatches a partial group as soon as its most urgent ticket's budget
    nears exhaustion, so bulk traffic accumulates into larger groups while
    interactive requests flush early (DESIGN.md §12).
  * **Predictive hot-set serving** — broker traffic feeds a popularity
    -decayed :class:`~repro_torch.runtime.pipeline.predictor.HeatTracker`;
    the ingest worker's idle gaps run one
    :class:`~repro_torch.runtime.pipeline.predictor.SpeculativePrethinner`
    unit each (pre-derived thinned plans/containers/permutation slices +
    the hot set's fused shapes with their launchers resolved), so the
    first real request for hot content is a memo hit + cached-launcher
    dispatch.  Speculation never blocks decode dispatch (separate thread)
    and yields to queued ingest work after at most one unit.
  * **Ingest coalescing** — queued ingest events for distinct contents fuse
    into ONE batched ``ingest_batch`` dispatch (per-event ``n_splits``
    preserved); repeats of one name stay ordered across batches.
  * **Consistency** — groups are prepared at dispatch time under the
    service lock (``DecodeService.dispatch_group``), so a concurrent
    re-registration can never tear a group across content versions.

  * **Supervised workers** (DESIGN.md §14) — both worker loops run under a
    supervisor: an exception that escapes the loop body (a bug in the
    controller, a fault injected outside the dispatch error handling, a
    speculation unit blowing up) fulfils the affected tickets with the
    error, restores the ``_inflight``/``_ingest_inflight`` invariants from
    the worker's in-flight work slot, increments ``worker_restarts``, and
    restarts the loop — no client ever blocks on a dead thread and
    ``drain()``/``close()`` always return.
  * **Graceful degradation** (DESIGN.md §14) — transient dispatch faults
    retry with bounded exponential backoff (per-ticket opt-in via
    ``submit(..., retries=)``); content whose dispatch keeps failing is
    quarantined (``submit`` serves :class:`ContentQuarantined` with a
    ``retry_after_s`` hint instead of wedging a lane); a lane whose fused
    group path keeps faulting falls back to per-request dispatch until a
    probe run of singles succeeds.

Lock order: broker queue lock (``_cv``) and the service lock are never held
together by the broker (queues are popped first, dispatch runs after), and
``drain``/``close`` must not be called while holding the service lock.

Counter discipline (single-writer invariant): every broker counter —
``submitted``/``completed``/``dispatch_errors``/``stream_dispatches``/
``worker_restarts``/... — is mutated ONLY under ``_cv``, and ``snapshot()``
reads under ``_cv``, so any snapshot is an internally consistent cut
(monotone across reads; ``submitted == completed + cancelled`` once
drained).  Keep it that way: a counter bumped outside ``_cv`` can be torn
against a concurrent snapshot (the pre-§14 ``completed`` bug).

Readiness: a launch returns once its kernels are queued.  Where the
reference blocks on an array, each wait here is on the readiness event the
service recorded right after that launch (``DecodeTicket.ready``,
``StreamTicket.synchronize``), never a device-wide synchronize, which
would also wait for ingest kernels the other worker queued later and
charge them to the decode's service time.  Each wait sits inside the
``try`` of its dispatch, so a CUDA error, which surfaces at the wait,
reaches the same failure handler as any other dispatch fault.  Where a
trace is live the service waits inside ``dispatch_group``, before it
fulfills the tickets, so the handler may retry them; otherwise the tickets
were fulfilled at the launch (as the reference's are before its
``block_until_ready``), the handler counts the error and retries nothing,
and the caller meets the error at ``result()``'s own wait.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import torch

from ..metrics import LatencyWindow, OverlapClock
from ..serve import DecodeTicket, StreamTicket

from .capability import CapabilityRegistry
from .controller import AdaptiveController, ControllerConfig
from .predictor import HeatTracker, SpeculativePrethinner


def _wait_ready(tickets) -> None:
    """Wait for the launches behind ``tickets``' outputs: each ticket holds
    the readiness event its dispatch recorded right after the launch (one
    event per group; None on the CPU, where the launch ran to its end)."""
    events = {id(t.ready): t.ready for t in tickets if t.ready is not None}
    for ev in events.values():
        ev.synchronize()


def _on_device(device):
    """Make ``device`` the calling worker thread's current CUDA device (a
    new thread starts on device 0); a null context on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


class BrokerSaturated(RuntimeError):
    """Admission rejection: a queue bound (total or per-lane) is reached.
    Callers back off (or surface 429-style pushback); nothing was enqueued.
    ``retry_after_s`` is the broker's drain estimate for the rejected
    queue — EMA service time x the group count needed to clear it — the
    number a 429/Retry-After header would carry."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class TicketCancelled(RuntimeError):
    """Raised by ``result()`` on a ticket whose request was cancelled."""


class ContentQuarantined(RuntimeError):
    """Served for content whose dispatch failed repeatedly: the broker
    refuses new submits for ``retry_after_s`` seconds instead of letting a
    poisoned asset wedge its lane with guaranteed-to-fail dispatches.
    After expiry one probe request is admitted (half-open) — a further
    failure re-quarantines immediately, a success clears the record."""

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(
            f"content {name!r} is quarantined after repeated dispatch "
            f"faults; retry in {retry_after_s:.3f}s")
        self.name = name
        self.retry_after_s = retry_after_s


class PipelineTicket(DecodeTicket):
    """Cross-thread future for a broker request (decode or ingest).

    ``result(timeout)`` blocks on the worker's completion event —
    timestamps record submit/dispatch/completion for the latency windows.
    ``cancel()`` withdraws the request: cancelled tickets are dropped when
    the worker builds its dispatch group (they never reach the engine), and
    a cancel that races an in-flight dispatch discards the delivered result
    — ``result()`` raises :class:`TicketCancelled` either way.

    Decode tickets carry their deadline (DESIGN.md §12): ``deadline_at`` is
    when the resolved class budget exhausts, ``flush_at`` the earlier point
    (margin subtracted) at which the lane scheduler force-dispatches a
    partial group rather than let the ticket breach.

    ``retries_left`` (from ``submit(..., retries=)``) opts the ticket into
    transient-fault retry: a dispatch error on a ticket with retries left
    does NOT complete it — ``_fulfill`` parks it as retry-pending and the
    broker's failure handler re-enqueues it with exponential backoff
    (DESIGN.md §14).  ``_fulfill_final`` bypasses the retry branch for
    terminal deliveries (retries exhausted, quarantine, supervisor
    recovery, broker close).
    """

    __slots__ = ("_event", "_mutex", "_cancelled", "kind", "submitted_at",
                 "dispatched_at", "completed_at", "deadline_class",
                 "deadline_at", "flush_at", "retries_left", "retry_attempt",
                 "_retry_pending")

    def __init__(self, svc, kind: str = "decode", retries: int = 0):
        super().__init__(svc)
        self._event = threading.Event()
        self._mutex = threading.Lock()   # orders cancel() vs _fulfill()
        self._cancelled = False
        self.kind = kind
        self.submitted_at = time.perf_counter()
        self.dispatched_at = None
        self.completed_at = None
        self.deadline_class = None
        self.deadline_at = None
        self.flush_at = None
        self.retries_left = int(retries)
        self.retry_attempt = 0
        self._retry_pending = False

    def _fulfill(self, out=None, err=None) -> None:
        with self._mutex:
            if self._cancelled:
                return   # cancelled in flight: the late result is dropped
            if (err is not None and self.retries_left > 0
                    and not isinstance(err, TicketCancelled)):
                # Not terminal: the broker's dispatch-failure handler sees
                # the pending flag and re-enqueues (or finalizes, if the
                # content was quarantined / the broker is closing).  The
                # provisional ``err`` is overwritten by the next attempt.
                self._retry_pending = True
                self.err = err
                return
            self.out = out
            self.err = err
            self.completed_at = time.perf_counter()
            self._event.set()

    def _fulfill_final(self, out=None, err=None) -> None:
        """Terminal delivery that never parks as retry-pending (supervisor
        recovery, retry exhaustion, quarantine, close)."""
        with self._mutex:
            if self._cancelled or self._event.is_set():
                return
            self._retry_pending = False
            self.out = out
            self.err = err
            self.completed_at = time.perf_counter()
            self._event.set()

    def _claim_retry(self) -> bool:
        """Broker failure handler: spend one retry from the budget.  Works
        whether or not a provisional error was parked — broker-level faults
        (quantize, group build) raise BEFORE the service's fulfill loop, so
        ``_retry_pending`` may never have been set.  False when the ticket
        has no budget left, was cancelled, or is already terminal."""
        with self._mutex:
            if self._cancelled or self._event.is_set():
                return False
            if self.retries_left <= 0:
                return False
            self._retry_pending = False
            self.retries_left -= 1
            self.retry_attempt += 1
            self.err = None
            return True

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Withdraw the request.  True iff the cancellation wins — the
        caller will never observe a result (queued tickets are dropped at
        dispatch-group build time; in-flight ones have their result
        discarded on delivery).  False if the request already completed."""
        with self._mutex:
            if self._event.is_set():
                return False
            self._cancelled = True
            self.err = TicketCancelled(f"{self.kind} request cancelled")
            self.completed_at = time.perf_counter()
            self._event.set()
        # Outside the mutex (trace has its own lock): the open interval —
        # queue wait or in-flight dispatch — becomes the terminal
        # "cancelled" span; late phases from a racing dispatch are dropped.
        self.trace.finish("cancelled", self.completed_at)
        return True

    def result(self, timeout: float | None = 120.0):
        """The decode output (device symbol tensor, already written: the
        wait covers the readiness event of its launch) or ingest result
        (:class:`~repro_torch.core.recoil.RecoilPlan`); raises the dispatch
        error
        if the request failed, :class:`TicketCancelled` if it was
        cancelled, TimeoutError if the broker never completed it within
        ``timeout`` seconds (the request stays queued/in flight — a timed
        -out caller typically follows up with ``cancel()``)."""
        if not self._event.wait(timeout):
            # Zero-width marker, not a terminal: the request is still
            # queued/in flight and may yet complete (or be cancelled).
            self.trace.event("result_timeout", timeout_s=timeout)
            raise TimeoutError(
                f"{self.kind} request not completed within {timeout}s")
        if self.err is not None:
            raise self.err
        if self.ready is not None:
            self.ready.synchronize()
        return self.out


class PipelineBroker:
    """Async serving pipeline over a :class:`DecodeService` (module
    docstring).  Construct via ``svc.start_pipeline(...)`` so the service
    façade routes ``submit``/``flush`` through the broker."""

    def __init__(self, svc, *, controller: AdaptiveController | None = None,
                 config: ControllerConfig | None = None,
                 max_queue: int = 512, max_ingest_queue: int = 64,
                 ingest_coalesce: int = 8, quantize_groups: bool = True,
                 max_lane_depth: int | None = None, predictive: bool = True,
                 heat_half_life_s: float = 30.0, speculate_top_k: int = 16,
                 speculative_capacity: int | None = None,
                 min_heat: float = 0.25,
                 registry_max_entries: int | None = None,
                 retry_backoff_ms: float = 10.0,
                 quarantine_after: int = 3, quarantine_s: float = 30.0,
                 degrade_after: int = 2, degraded_probe: int = 4):
        self.svc = svc
        if controller is None and config is None:
            # A tuned service quantizes to the profile's measured microbatch
            # sizes, so warm() resolves exactly the shape set dispatch will
            # request — no warm-miss launcher resolves under a tuned profile.
            profile = getattr(svc, "tuning_profile", None)
            if profile is not None and profile.microbatch_sizes:
                sizes = tuple(sorted(int(s)
                                     for s in profile.microbatch_sizes))
                config = ControllerConfig(max_batch=sizes[-1],
                                          batch_sizes=sizes)
        self.controller = controller or AdaptiveController(config)
        # Request-level bucketing: a deadline flush of a partial lane (say 3
        # queued) is padded to the next quantized size with ticketless
        # repeats of its own requests, so partial groups reuse the warmed
        # launchers instead of minting fresh bucket shapes (the same
        # pad-to-bucket policy the engine applies to rows/steps/streams,
        # lifted to whole requests).  Waste is bounded by one quantization
        # step and only paid on partial flushes.
        self.quantize_groups = bool(quantize_groups)
        self.max_queue = int(max_queue)
        # Per-lane admission: one slow lane can no longer absorb the whole
        # global bound and starve the others of queue room.
        self.max_lane_depth = (int(max_lane_depth)
                               if max_lane_depth is not None
                               else self.max_queue)
        self.max_ingest_queue = int(max_ingest_queue)
        self.ingest_coalesce = int(ingest_coalesce)
        # Predictive hot-set serving (DESIGN.md §12): traffic heats the
        # tracker; the ingest worker's idle gaps run the pre-thinner.  The
        # tracker also ranks the registry's budget eviction (cold first).
        self.tracker = HeatTracker(half_life_s=heat_half_life_s)
        self.registry = CapabilityRegistry(
            svc, max_entries=registry_max_entries, tracker=self.tracker)
        self.prethinner = (SpeculativePrethinner(
            svc, self.registry, self.controller, self.tracker,
            top_k=speculate_top_k, min_heat=min_heat,
            capacity=speculative_capacity) if predictive else None)

        # Degradation knobs (DESIGN.md §14): exponential per-ticket retry
        # backoff base; consecutive single-content failures before a
        # content quarantines and how long it sits out; consecutive fused
        # -group failures before a lane degrades to per-request dispatch
        # and how many single successes re-earn the fused path.
        self.retry_backoff_s = float(retry_backoff_ms) * 1e-3
        self.quarantine_after = int(quarantine_after)
        self.quarantine_s = float(quarantine_s)
        self.degrade_after = int(degrade_after)
        self.degraded_probe = int(degraded_probe)

        self._cv = threading.Condition()
        self._lanes: dict[int, deque] = {}
        self._ingest_q: deque = deque()
        self._stream_q: deque = deque()   # chunked streaming decode jobs
        self._queued = 0            # decode + stream requests queued
        self._inflight = 0          # popped, not yet fulfilled (decode)
        self._ingest_inflight = 0
        self._closing = False
        # Reliability state (all under _cv).  The work slots hold what a
        # worker has popped but not yet completed — the supervisor's
        # recovery reads them to fulfil orphaned tickets and restore the
        # inflight counters when an exception escapes the loop body.
        self._decode_work = None    # ("group", lane, popped) | ("stream", job)
        self._ingest_work = None    # the popped ingest batch
        self._retry_q: list = []    # [retry_at, lane, ticket, name]
        self._content_faults: dict[str, int] = {}   # consecutive failures
        self._quarantine: dict[str, float] = {}     # name -> until (ts)
        self._lane_faults: dict[int, int] = {}      # consecutive group fails
        self._degraded: dict[int, int] = {}         # lane -> probe singles left

        # Instruments (runtime.metrics): request wait (submit->dispatch),
        # decode service (dispatch->result ready), ingest service, and the
        # exact ingest-vs-decode overlap clock.
        self.wait_window = LatencyWindow()
        self.service_window = LatencyWindow()
        self.ingest_window = LatencyWindow()
        self.clock = OverlapClock("decode", "ingest")
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.cancelled = 0          # tickets dropped at dispatch-group build
        self.dispatch_groups = 0
        self.dispatch_errors = 0
        self.ingest_events = 0
        self.ingest_dispatches = 0
        self.ingest_errors = 0
        self.extend_events = 0
        self.stream_dispatches = 0
        self.worker_restarts = 0    # supervisor recoveries (both workers)
        self.retries = 0            # tickets re-enqueued after a fault
        self.quarantined = 0        # quarantine entries created
        self.quarantine_rejects = 0  # submits refused ContentQuarantined
        self.degraded_dispatches = 0  # per-request fallback dispatch passes
        # Per-deadline-class SLO accounting, updated by the decode worker
        # under _cv: {class: {"fulfilled": n, "missed": n}} where a miss is
        # a ticket fulfilled after its deadline_at (DESIGN.md §13).
        self.deadline_stats: dict[str, dict] = {}

        self._decode_thread = threading.Thread(
            target=self._decode_worker, name="recoil-decode", daemon=True)
        self._ingest_thread = threading.Thread(
            target=self._ingest_worker, name="recoil-ingest", daemon=True)
        self._decode_thread.start()
        self._ingest_thread.start()

    # ------------------------------------------------------------------
    # Client API
    # ------------------------------------------------------------------

    def _retry_after_s(self, depth: int) -> float:
        """Drain estimate for a queue of ``depth`` requests: full-size
        groups at the controller's EMA service time for that size."""
        b = self.controller.cfg.max_batch
        groups = max((depth + b - 1) // b, 1)
        return groups * self.controller.service_s(b)

    def submit(self, name: str, n_threads: int,
               deadline=None, retries: int = 0) -> PipelineTicket:
        """Queue a decode on the ``n_threads`` capability lane.

        ``deadline`` is a deadline class name (``interactive`` /
        ``standard`` / ``bulk`` by default) or an explicit budget in ms;
        None takes the controller's default class.  The lane dispatches a
        partial group rather than let the ticket's budget exhaust.  The
        submission also heats the (content, capability) pair in the
        predictive tracker.

        ``retries`` opts the ticket into transient-fault retry: a dispatch
        error re-enqueues it (bounded exponential backoff) up to that many
        times before the error is delivered (DESIGN.md §14).  Quarantined
        content is refused up front with :class:`ContentQuarantined`
        carrying a ``retry_after_s`` hint."""
        if self.svc.generation(name) == 0:
            raise KeyError(f"content {name!r} is not registered")
        cls, budget_ms = self.controller.budget_ms(deadline)
        lane = int(n_threads)
        self.tracker.observe(name, lane)
        ticket = PipelineTicket(self.svc, kind="decode", retries=retries)
        ticket.trace = self.svc.obs.tracer.start(
            "decode", name=name, t0=ticket.submitted_at,
            n_threads=lane, deadline=cls)
        ticket.deadline_class = cls
        ticket.deadline_at = ticket.submitted_at + budget_ms * 1e-3
        margin_ms = min(self.controller.cfg.deadline_margin_ms,
                        0.2 * budget_ms)
        ticket.flush_at = ticket.deadline_at - margin_ms * 1e-3
        with self._cv:
            if self._closing:
                ticket.trace.finish("error", error="broker is closed")
                raise RuntimeError("broker is closed")
            until = self._quarantine.get(name)
            if until is not None:
                now = time.perf_counter()
                if now < until:
                    self.quarantine_rejects += 1
                    raise self._reject(ticket, ContentQuarantined(
                        name, retry_after_s=until - now),
                        status="quarantined")
                # Expired: half-open — admit ONE probe request, but keep
                # the fault count at threshold-1 so a further failure
                # re-quarantines immediately while a success clears it.
                del self._quarantine[name]
                self._content_faults[name] = self.quarantine_after - 1
            if self._queued + self._inflight >= self.max_queue:
                self.rejected += 1
                raise self._reject(ticket, BrokerSaturated(
                    f"decode queue at bound {self.max_queue}",
                    retry_after_s=self._retry_after_s(self._queued)))
            lane_q = self._lanes.setdefault(lane, deque())
            if len(lane_q) >= self.max_lane_depth:
                self.rejected += 1
                raise self._reject(ticket, BrokerSaturated(
                    f"lane {lane} at depth bound {self.max_lane_depth}",
                    retry_after_s=self._retry_after_s(len(lane_q))))
            ticket.trace.phase("admission")
            lane_q.append((ticket, name))
            self._queued += 1
            self.submitted += 1
            self.controller.observe_arrival(lane, ticket.submitted_at)
            self._cv.notify_all()
        return ticket

    @staticmethod
    def _reject(ticket, err, status: str = "rejected"):
        """Terminate a ticket's trace as an admission rejection (the
        ``retry_after_s`` hint lands in the trace meta) and hand back the
        exception for the caller to raise — nothing was enqueued."""
        ticket.trace.phase("admission", rejected=True,
                           retry_after_s=err.retry_after_s)
        ticket.trace.finish(status)
        return err

    def anticipate(self, name: str, n_threads: int,
                   weight: float = 1.0) -> None:
        """Declare expected popularity for a (content, capability) pair
        without submitting a request — same decayed counter real traffic
        feeds, synthetic weight.  Operators use this to pre-heat a launch's
        hot set; the next idle gaps (or :meth:`speculate`) pre-derive it."""
        self.tracker.observe(name, int(n_threads), weight)

    def speculate(self) -> int:
        """Drive the speculative pre-thinner to empty from the caller's
        thread (blocking): every due hot-set pair derived, every implied
        fused shape whose launcher is missing launched once.  Returns units
        run; 0 when the hot set is already covered (or prediction is
        disabled).  The idle-gap path does the same work incrementally —
        this is for deterministic pre-warming after :meth:`anticipate` and
        for benchmarks."""
        return 0 if self.prethinner is None else self.prethinner.speculate()

    def submit_ingest(self, name: str, symbols, n_splits: int) -> PipelineTicket:
        """Queue an ingest (encode + split-plan + register) for the ingest
        worker; the ticket resolves to the registered RecoilPlan."""
        ticket = PipelineTicket(self.svc, kind="ingest")
        ticket.trace = self.svc.obs.tracer.start(
            "ingest", name=name, t0=ticket.submitted_at)
        with self._cv:
            if self._closing:
                ticket.trace.finish("error", error="broker is closed")
                raise RuntimeError("broker is closed")
            if len(self._ingest_q) + self._ingest_inflight \
                    >= self.max_ingest_queue:
                self.rejected += 1
                raise self._reject(ticket, BrokerSaturated(
                    f"ingest queue at bound {self.max_ingest_queue}",
                    retry_after_s=self._ingest_retry_after_s()))
            ticket.trace.phase("admission")
            self._ingest_q.append((ticket, name, symbols, int(n_splits)))
            self.ingest_events += 1
            self._cv.notify_all()
        return ticket

    def _ingest_retry_after_s(self) -> float | None:
        """Drain hint for a saturated ingest queue (measured mean ingest
        service time x queued events; None before any observation)."""
        mean_ms = self.ingest_window.summary_ms()["mean_ms"]
        if mean_ms <= 0:
            return None
        return (len(self._ingest_q) + self._ingest_inflight) * mean_ms * 1e-3

    def submit_extend(self, name: str, delta) -> PipelineTicket:
        """Queue an incremental re-ingest (``DecodeService.extend``): the
        ingest worker resumes the encoder's cached state chain and encodes
        only the appended suffix.  Rides the ingest queue — FIFO per name,
        so an extend can never be applied before the ingest (or earlier
        extend) it grows; the ticket resolves to the grown RecoilPlan.
        Extends always dispatch singly (never inside a batched
        ``ingest_batch`` — suffix shapes are per-content)."""
        ticket = PipelineTicket(self.svc, kind="extend")
        ticket.trace = self.svc.obs.tracer.start(
            "extend", name=name, t0=ticket.submitted_at)
        with self._cv:
            if self._closing:
                ticket.trace.finish("error", error="broker is closed")
                raise RuntimeError("broker is closed")
            if len(self._ingest_q) + self._ingest_inflight \
                    >= self.max_ingest_queue:
                self.rejected += 1
                raise self._reject(ticket, BrokerSaturated(
                    f"ingest queue at bound {self.max_ingest_queue}",
                    retry_after_s=self._ingest_retry_after_s()))
            ticket.trace.phase("admission")
            self._ingest_q.append((ticket, name, delta, 0))
            self.ingest_events += 1
            self.extend_events += 1
            self._cv.notify_all()
        return ticket

    def submit_stream(self, name: str, n_threads: int,
                      n_chunks: int = 8) -> StreamTicket:
        """Queue a chunked streaming decode; the decode worker launches the
        chunks (streams preempt lane grouping — they are the
        latency-sensitive path).  Returns the service's
        :class:`~repro_torch.runtime.serve.StreamTicket` — per-chunk results
        arrive as the worker dispatches them."""
        if self.svc.generation(name) == 0:
            raise KeyError(f"content {name!r} is not registered")
        ticket = StreamTicket(
            self.svc.stream_chunk_count(name, n_threads, n_chunks))
        ticket.trace = self.svc.obs.tracer.start(
            "stream", name=name, t0=ticket.submitted_at,
            n_threads=int(n_threads))
        with self._cv:
            if self._closing:
                ticket.trace.finish("error", error="broker is closed")
                raise RuntimeError("broker is closed")
            if self._queued + self._inflight >= self.max_queue:
                self.rejected += 1
                raise self._reject(ticket, BrokerSaturated(
                    f"decode queue at bound {self.max_queue}",
                    retry_after_s=self._retry_after_s(self._queued)))
            ticket.trace.phase("admission")
            self._stream_q.append((ticket, name, int(n_threads),
                                   int(n_chunks)))
            self._queued += 1
            self.submitted += 1
            self._cv.notify_all()
        return ticket

    def drain(self, timeout: float | None = 120.0) -> None:
        """Block until every queued and in-flight request has completed.
        Must not be called while holding the service lock (the workers need
        it to dispatch)."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while (self._queued or self._inflight or self._ingest_q
                   or self._ingest_inflight):
                left = None if deadline is None \
                    else deadline - time.perf_counter()
                if left is not None and left <= 0:
                    raise TimeoutError("broker drain timed out")
                self._cv.wait(timeout=0.05 if left is None
                              else min(left, 0.05))

    def close(self) -> None:
        """Finish all queued work, stop the workers, detach from the
        service.  Idempotent."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        self._decode_thread.join(timeout=120)
        self._ingest_thread.join(timeout=120)
        with self.svc._lock:
            if self.svc._broker is self:
                self.svc._broker = None

    def __enter__(self) -> "PipelineBroker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # Warmup
    # ------------------------------------------------------------------

    def warm(self, names, capabilities) -> None:
        """Resolve the launcher of every fused-group shape the controller
        can form over ``names`` x ``capabilities``: for each capability
        lane, each quantized batch size, and each power-of-two
        distinct-content count, one dispatch, waited for.  The launcher
        cache key (the plan key) depends only on bucketed dims (row sum,
        step bucket, fused-stream bucket, output bucket) and the layout, so
        this enumeration covers the steady state — after it, a well-formed
        load resolves no launcher (``svc.stats.compiles`` stays put)."""
        names = list(names)
        sizes = self.controller.cfg.sizes()
        for cap in capabilities:
            for size in sizes:
                distinct = {min(d, len(names), size)
                            for d in (1, 2, 4, 8, size)}
                for d in sorted(distinct):
                    reqs = [(names[i % d], cap) for i in range(size)]
                    tickets = [DecodeTicket(self.svc) for _ in reqs]
                    self.svc.dispatch_group(reqs, tickets)
                    _wait_ready(tickets)

    # ------------------------------------------------------------------
    # Workers
    # ------------------------------------------------------------------

    def _pick_lane(self, now: float):
        """Under ``_cv``: the dispatchable lane with the oldest head
        request (fairness), or (None, wait_ms) when every lane should keep
        accumulating.  Deadline-aware: each lane's flush slack is the
        minimum remaining margin-adjusted budget over its queued tickets
        (NOT just the head's — an interactive ticket queued behind bulk
        ones must still flush the lane in time)."""
        best, best_take, best_age = None, 0, -1.0
        min_wait = None
        for lane, q in self._lanes.items():
            if not q:
                continue
            oldest = q[0][0].submitted_at
            age_ms = (now - oldest) * 1e3
            slack_ms = min(
                (t.flush_at - now) * 1e3 for t, _ in q)
            decision = self.controller.decide(lane, len(q), age_ms, now,
                                              flush_slack_ms=slack_ms)
            if decision.dispatch:
                if age_ms > best_age:
                    best, best_take, best_age = lane, decision.batch, age_ms
            else:
                min_wait = (decision.wait_more_ms if min_wait is None
                            else min(min_wait, decision.wait_more_ms))
        return best, best_take, min_wait

    def _supervise(self, loop, recover) -> None:
        """Run a worker loop under supervision (DESIGN.md §14): an exception
        that escapes the loop body — i.e. one the dispatch error handling
        did NOT absorb — is a worker crash.  ``recover`` fulfils the
        orphaned tickets from the worker's in-flight work slot, restores
        the inflight counters, and bumps ``worker_restarts``; then the loop
        restarts, so a crashed worker never leaves ``drain()``/``close()``
        hanging on a dead thread.  A normal return (closing, queues empty)
        ends the thread."""
        while True:
            try:
                loop()
                return
            except BaseException as e:   # noqa: BLE001 — supervisor catches all
                recover(e)
                time.sleep(0.001)   # yield: never hot-spin a crash loop

    def _decode_worker(self) -> None:
        with _on_device(self.svc.session.device):
            self._supervise(self._decode_main, self._recover_decode)

    def _ingest_worker(self) -> None:
        with _on_device(self.svc.session.device):
            self._supervise(self._ingest_main, self._recover_ingest)

    def _recover_decode(self, e) -> None:
        """Supervisor recovery for the decode worker: deliver ``e`` to every
        ticket the crashed iteration had popped (terminally — a crash is
        not a retryable dispatch fault) and restore ``_inflight``."""
        with self._cv:
            work, self._decode_work = self._decode_work, None
            if work is not None and work[0] == "stream":
                ticket = work[1][0]
                self._inflight -= 1
                self.completed += 1
                if ticket.err is None and ticket.completed_at is None:
                    ticket._fail(e)
                    ticket.trace.finish("error", error=repr(e),
                                        supervisor=True)
            elif work is not None:
                _, lane, popped = work
                self._inflight -= len(popped)
                for t, _ in popped:
                    if t.cancelled:
                        self.cancelled += 1
                        continue
                    t._fulfill_final(err=e)
                    t.trace.finish("error", error=repr(e), supervisor=True)
                    self.completed += 1
            self.worker_restarts += 1
            self._cv.notify_all()

    def _recover_ingest(self, e) -> None:
        """Supervisor recovery for the ingest worker (mirror of
        :meth:`_recover_decode` over the popped ingest batch)."""
        with self._cv:
            work, self._ingest_work = self._ingest_work, None
            if work is not None:
                self._ingest_inflight -= len(work)
                self.ingest_errors += 1
                for ticket, *_ in work:
                    if ticket.cancelled:
                        self.cancelled += 1
                        continue
                    ticket._fulfill_final(err=e)
                    ticket.trace.finish("error", error=repr(e),
                                        supervisor=True)
            self.worker_restarts += 1
            self._cv.notify_all()

    def _promote_due_retries(self, now: float) -> float | None:
        """Under ``_cv``: move due retry entries back onto their lanes
        (they kept their ``_queued`` slot while backing off, so ``drain``
        keeps waiting on them).  On close every entry promotes immediately
        — backoff must not outlive the broker.  Returns seconds until the
        next still-pending entry is due (None when the queue is empty)."""
        due = None
        keep = []
        for entry in self._retry_q:
            retry_at, lane, ticket, name = entry
            if retry_at <= now or self._closing:
                self._lanes.setdefault(lane, deque()).append((ticket, name))
            else:
                keep.append(entry)
                left = retry_at - now
                due = left if due is None else min(due, left)
        self._retry_q = keep
        return due

    def _decode_main(self) -> None:
        while True:
            with self._cv:
                now = time.perf_counter()
                retry_due = self._promote_due_retries(now)
                # Streams preempt lane grouping: a stream request wants its
                # first chunk NOW — it never waits behind a lane's adaptive
                # accumulation window (chunks are single-request plans, so
                # there is nothing to coalesce anyway).
                job = None
                if self._stream_q:
                    job = self._stream_q.popleft()
                    self._queued -= 1
                    self._inflight += 1
                    self._decode_work = ("stream", job)
                else:
                    lane, take, min_wait = self._pick_lane(now)
                    if lane is None:
                        if self._closing:
                            if self._queued == 0:
                                break
                            # closing with partial lanes: flush them now
                            lane = max(
                                (l for l, q in self._lanes.items() if q),
                                key=lambda l: len(self._lanes[l]))
                            take = min(len(self._lanes[lane]),
                                       self.controller.cfg.max_batch)
                        else:
                            timeout = (None if min_wait is None
                                       else max(min_wait, 1.0) * 1e-3)
                            if retry_due is not None:
                                timeout = (retry_due if timeout is None
                                           else min(timeout, retry_due))
                            self._cv.wait(timeout=timeout)
                            continue
                    q = self._lanes[lane]
                    popped = [q.popleft() for _ in range(min(take, len(q)))]
                    self._queued -= len(popped)
                    self._inflight += len(popped)
                    self._decode_work = ("group", lane, popped)
            # Reliability fault point OUTSIDE the dispatch error handling:
            # only the supervisor can catch it (tests/test_reliability.py).
            self.svc.faults.fire("broker.decode_worker")
            if job is not None:
                self._dispatch_stream(job)
            else:
                self._dispatch(lane, popped)

    def _dispatch_stream(self, job) -> None:
        ticket, name, n_threads, n_chunks = job
        t0 = self.clock.begin("decode")
        self.wait_window.record(t0 - ticket.submitted_at)
        ticket.trace.phase("queue", t0)
        err = None
        try:
            self.svc.dispatch_stream(name, n_threads, n_chunks, ticket)
            ticket.synchronize(ticket.n_chunks - 1)
        except Exception as e:
            err = e
        t1 = self.clock.end("decode")
        self.service_window.record(t1 - t0)
        with self._cv:
            if err is not None:
                self.dispatch_errors += 1
            self._inflight -= 1
            self._decode_work = None
            self.stream_dispatches += 1
            self.completed += 1
            self._cv.notify_all()
        if err is not None and ticket.err is None \
                and ticket.completed_at is None:
            # Belt and suspenders: dispatch_stream fails its own ticket, but
            # a fault escaping before it runs (or a CUDA error at the wait
            # after the chunks fulfilled) must still unblock the caller.
            ticket._fail(err)
            ticket.trace.finish("error", error=repr(err))

    def _dispatch(self, lane: int, popped: list) -> None:
        # Cancelled tickets are dropped HERE — at dispatch-group build time
        # — so a withdrawn request never reaches the engine and never pads
        # a fused launch.  (A cancel landing after this point races
        # the in-flight dispatch; the ticket's mutex discards the result.)
        live = [p for p in popped if not p[0].cancelled]
        with self._cv:
            self.cancelled += len(popped) - len(live)
            degraded = lane in self._degraded
            if not live:
                self._inflight -= len(popped)
                self._decode_work = None
                self._cv.notify_all()
                return
        t0 = self.clock.begin("decode")
        for t, _ in live:
            t.dispatched_at = t0
            t.trace.phase("queue", t0)
            self.wait_window.record(t0 - t.submitted_at)
        if degraded:
            dispatched = self._dispatch_singles(lane, live)
        else:
            dispatched = self._dispatch_fused(lane, live)
        t1 = self.clock.end("decode")
        if dispatched:
            # A faulted pass observes nothing: its timing would train the
            # controller's service-time EMA on failure latency.
            self.controller.observe_service(dispatched, t1 - t0)
        for _ in live:
            self.service_window.record(t1 - t0)
        with self._cv:
            self._inflight -= len(popped)
            self._decode_work = None
            self.dispatch_groups += 1
            # A retry-pending ticket is not done: it completes (and counts)
            # on its terminal pass, so ``submitted == completed + cancelled``
            # still holds once drained.
            self.completed += sum(1 for t, _ in live if t.done())
            # Deadline SLO accounting (per class): a ticket fulfilled after
            # its deadline_at is a miss — the number the flush-early policy
            # exists to keep low, now counted instead of inferred.
            for t, _ in live:
                if (t.deadline_at is None or t.cancelled
                        or t.completed_at is None):
                    continue
                d = self.deadline_stats.setdefault(
                    t.deadline_class, {"fulfilled": 0, "missed": 0})
                d["fulfilled"] += 1
                if t.completed_at > t.deadline_at:
                    d["missed"] += 1
            self._cv.notify_all()

    def _dispatch_fused(self, lane: int, live: list) -> int:
        """The fused group path: quantize to a warmed bucket size (padding
        with ticketless repeats of the group's own requests) and run ONE
        ``dispatch_group``.  Everything that can raise — including the
        quantize/filler construction, which once ran before the ``try``
        and killed the worker thread, and the wait, where a CUDA error
        surfaces — is inside the try, so a fault lands in the failure
        handler instead of escaping the loop.
        Returns the dispatched request count (0 on fault) for the
        controller's service-time observation."""
        tickets = [t for t, _ in live]
        requests = [(name, lane) for _, name in live]
        try:
            self.svc.faults.fire("broker.quantize", lane=lane,
                                 n=len(requests))
            if self.quantize_groups:
                target = self.controller.quantize(len(requests))
                for i in range(target - len(requests)):
                    requests.append(requests[i % len(live)])
                    tickets.append(DecodeTicket(self.svc))  # ticketless filler
            self.svc.dispatch_group(requests, tickets)
            _wait_ready(tickets)
        except Exception as e:
            with self._cv:
                self.dispatch_errors += 1
                n = self._lane_faults.get(lane, 0) + 1
                self._lane_faults[lane] = n
                if n >= self.degrade_after:
                    # Consecutive fused faults: the lane falls back to
                    # per-request dispatch until a probe run of singles
                    # succeeds (DESIGN.md §14).
                    self._degraded[lane] = self.degraded_probe
                self._handle_dispatch_failure(lane, live, e)
            return 0
        with self._cv:
            self._note_dispatch_success(
                lane, {name for _, name in live}, fused=True)
        return len(requests)

    def _dispatch_singles(self, lane: int, live: list) -> int:
        """Degraded mode (DESIGN.md §14): the lane's fused path kept
        faulting, so serve each request individually — no quantization, no
        fillers, no shared fate — until ``degraded_probe`` consecutive
        singles succeed and the lane re-earns fusion.  Slower (per-request
        dispatches) but isolates a poisoned group member instead of failing
        every rider.  Returns the count of successful dispatches."""
        with self._cv:
            self.degraded_dispatches += 1
        ok = 0
        for ticket, name in live:
            if ticket.cancelled:
                continue
            try:
                self.svc.dispatch_group([(name, lane)], [ticket])
                _wait_ready([ticket])
                ok += 1
                with self._cv:
                    self._note_dispatch_success(lane, (name,), fused=False)
            except Exception as e:
                with self._cv:
                    self.dispatch_errors += 1
                    self._degraded[lane] = self.degraded_probe  # probe resets
                    self._handle_dispatch_failure(lane, [(ticket, name)], e)
        return ok

    def _handle_dispatch_failure(self, lane: int, live: list, e) -> None:
        """Caller holds ``_cv``.  The per-fault state machine (DESIGN.md
        §14): attribute the fault to its content when attribution is exact
        (every request in the failed dispatch names ONE content — a mixed
        group's fault could be any member's), quarantine on repeated
        faults, then decide retry-vs-finalize for each affected ticket."""
        now = time.perf_counter()
        names = {name for _, name in live}
        quarantined_err = None
        if len(names) == 1:
            name = next(iter(names))
            n = self._content_faults.get(name, 0) + 1
            self._content_faults[name] = n
            if n >= self.quarantine_after:
                self._quarantine[name] = now + self.quarantine_s
                self.quarantined += 1
                quarantined_err = ContentQuarantined(
                    name, retry_after_s=self.quarantine_s)
        for ticket, name in live:
            if ticket.done():
                continue   # terminal already (no retries left, or cancelled)
            if not ticket._claim_retry():
                # Belt and suspenders: no retry budget, and the
                # raising dispatch may never have reached its own fulfill
                # loop — deliver the error terminally rather than strand
                # the caller.
                ticket._fulfill_final(err=e)
                ticket.trace.finish("error", error=repr(e))
                continue
            if quarantined_err is not None or self._closing:
                final = quarantined_err if quarantined_err is not None else e
                ticket._fulfill_final(err=final)
                ticket.trace.finish("error", error=repr(final))
                continue
            backoff = self.retry_backoff_s * (2 ** (ticket.retry_attempt - 1))
            self._retry_q.append([now + backoff, lane, ticket, name])
            self._queued += 1
            self.retries += 1
            ticket.trace.event("retry", attempt=ticket.retry_attempt,
                               backoff_s=round(backoff, 6))
        self._cv.notify_all()

    def _note_dispatch_success(self, lane: int, names, fused: bool) -> None:
        """Caller holds ``_cv``.  A clean dispatch clears the consecutive
        -fault records for its contents (and lane, on the fused path); on
        the degraded path it pays down the lane's probe budget — after
        ``degraded_probe`` clean singles the lane re-earns fusion."""
        for name in names:
            self._content_faults.pop(name, None)
            self._quarantine.pop(name, None)
        if fused:
            self._lane_faults.pop(lane, None)
        elif lane in self._degraded:
            left = self._degraded[lane] - 1
            if left <= 0:
                del self._degraded[lane]
                self._lane_faults.pop(lane, None)
            else:
                self._degraded[lane] = left

    def _pop_ingest_batch(self):
        """Under ``_cv``: a queue prefix of events with DISTINCT names (a
        repeated name must stay ordered across batches so a later refresh
        cannot be registered before an earlier one), bounded by the
        coalescing width.  Extend events never share a batch with ingests
        (or other extends): the suffix encode resumes per-content state, so
        there is nothing to batch — each extend dispatches singly, still
        FIFO-ordered against the ingests of its name."""
        batch, names = [], set()
        while self._ingest_q and len(batch) < self.ingest_coalesce:
            head = self._ingest_q[0]
            if head[1] in names:
                break
            if batch and head[0].kind == "extend":
                break
            ev = self._ingest_q.popleft()
            names.add(ev[1])
            batch.append(ev)
            if ev[0].kind == "extend":
                break
        return batch

    def _ingest_main(self) -> None:
        while True:
            batch = None
            with self._cv:
                if not self._ingest_q:
                    if self._closing:
                        break
                else:
                    batch = self._pop_ingest_batch()
                    self._ingest_inflight += len(batch)
                    self._ingest_work = batch
            if batch is None:
                # Idle gap: at most ONE speculative unit (pre-thin a hot
                # pair or warm a missing fused shape), run OUTSIDE the
                # queue lock — the prethinner takes the service lock, and
                # §8's audit forbids holding both.  Queued ingest work
                # arriving mid-unit waits at most that unit; decode
                # dispatch is never blocked (separate worker thread).
                if self.prethinner is not None and self.prethinner.step():
                    continue
                with self._cv:
                    if not self._ingest_q and not self._closing:
                        self._cv.wait(timeout=0.05)
                continue
            # Reliability fault point outside the dispatch error handling —
            # only the supervisor can catch it (tests/test_reliability.py).
            self.svc.faults.fire("broker.ingest_worker")
            # Same drop point as decode: cancelled ingests never encode.
            live = [ev for ev in batch if not ev[0].cancelled]
            t0 = self.clock.begin("ingest")
            for ticket, *_ in live:
                ticket.trace.phase("queue", t0)
            err = None
            try:
                if len(live) == 1:
                    ticket, name, symbols, n_splits = live[0]
                    if ticket.kind == "extend":
                        plan = self.svc.extend(name, symbols)
                    else:
                        plan = self.svc.ingest(name, symbols, n_splits)
                    ticket._fulfill_final(out=plan)
                    ticket.trace.phase("execute")
                    ticket.trace.finish("ok")
                elif live:
                    contents = {name: symbols
                                for _, name, symbols, _ in live}
                    plans = self.svc.ingest_batch(
                        contents, [n for _, _, _, n in live])
                    for ticket, name, _, _ in live:
                        ticket._fulfill_final(out=plans[name])
                        ticket.trace.phase("execute", batch=len(live))
                        ticket.trace.finish("ok")
            except Exception as e:
                err = e
                for ticket, *_ in live:
                    ticket._fulfill_final(err=e)
                    ticket.trace.finish("error", error=repr(e))
            t1 = self.clock.end("ingest")
            for _ in live:
                self.ingest_window.record((t1 - t0) / len(live))
            with self._cv:   # single-writer invariant: counters under _cv
                self.cancelled += len(batch) - len(live)
                if err is not None:
                    self.ingest_errors += 1
                if live:
                    self.ingest_dispatches += 1
                self._ingest_inflight -= len(batch)
                self._ingest_work = None
                self._cv.notify_all()

    # ------------------------------------------------------------------
    # Stats
    # ------------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return self._queued + len(self._ingest_q)

    def snapshot(self) -> dict:
        """The pipeline's observable state: queue depths, wait/service
        latency percentiles, overlap ratio, counters (asserted in tests and
        reported by ``bench_pipeline``)."""
        with self._cv:
            lanes = {lane: len(q) for lane, q in self._lanes.items() if q}
            depth = self._queued
            ingest_depth = len(self._ingest_q)
            deadline = {cls: dict(d)
                        for cls, d in self.deadline_stats.items()}
            reliability = {
                "worker_restarts": self.worker_restarts,
                "retries": self.retries,
                "retry_queue_depth": len(self._retry_q),
                "quarantined": self.quarantined,
                "quarantine_rejects": self.quarantine_rejects,
                "quarantined_contents": sorted(self._quarantine),
                "degraded_lanes": sorted(self._degraded),
                "degraded_dispatches": self.degraded_dispatches,
                "content_faults": dict(self._content_faults),
                "lane_faults": dict(self._lane_faults),
            }
        return {
            "queue_depth": depth,
            "ingest_queue_depth": ingest_depth,
            "lanes": lanes,
            "admission": {
                "max_queue": self.max_queue,
                "max_lane_depth": self.max_lane_depth,
                "lane_depths": dict(lanes),
                "retry_after_s": {
                    lane: round(self._retry_after_s(d), 4)
                    for lane, d in lanes.items()},
            },
            "heat": self.tracker.snapshot(),
            "predictive": (None if self.prethinner is None
                           else self.prethinner.snapshot()),
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "cancelled": self.cancelled,
            "dispatch_groups": self.dispatch_groups,
            "dispatch_errors": self.dispatch_errors,
            "ingest_events": self.ingest_events,
            "ingest_dispatches": self.ingest_dispatches,
            "ingest_errors": self.ingest_errors,
            "extend_events": self.extend_events,
            "stream_dispatches": self.stream_dispatches,
            "worker_restarts": reliability["worker_restarts"],
            "retries": reliability["retries"],
            "quarantine_rejects": reliability["quarantine_rejects"],
            "degraded_dispatches": reliability["degraded_dispatches"],
            "reliability": reliability,
            "wait": self.wait_window.summary_ms(),
            "service": self.service_window.summary_ms(),
            "ingest_service": self.ingest_window.summary_ms(),
            "overlap": self.clock.snapshot(),
            "controller": self.controller.snapshot(),
            "registry": self.registry.snapshot(),
            "deadline": deadline,
        }
