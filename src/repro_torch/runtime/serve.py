"""Content-delivery decode service.

``DecodeService`` is the rANS side of serving: encoded payloads registered
once (stream resident on the device), split metadata thinned per request to
the client's parallelism, and every decode dispatched through a persistent
:class:`repro_torch.core.engine.DecoderSession`, so steady-state traffic
re-resolves nothing.  Content enters either pre-encoded (``register``,
validated against the service model before it can serve) or as raw symbols
(``ingest``/``ingest_batch``/``extend`` — the
:class:`repro_torch.core.encode.EncoderSession` ingest engine encodes and
split-plans on the service's device, and the stream feeds registration
without visiting the host).  Two request paths:

  * ``decode(name, n_threads)`` — immediate single dispatch.  The prepared
    :class:`~repro_torch.core.engine.DecodePlan` is memoized per
    ``(name, n_threads)``, so repeat traffic skips the host-side thinning
    (``combine_plan`` + ``build_split_states`` + ``WalkBatch.from_splits``)
    AND the engine's padding/arg assembly — the steady state is one cached
    launch on cached device args.
  * ``submit(name, n_threads) -> DecodeTicket`` — microbatched.  Pending
    requests coalesce into ONE fused dispatch (``concat_walk_batches``:
    per-request ``out_base`` offsets write disjoint output windows; across
    different contents the resident streams are fused with per-stream word
    offsets applied to ``q0``).  Results come back as per-request device
    slices of the fused output.  Flush policy: an explicit ``flush()``, a
    full microbatch (``microbatch`` requests pending), a submit arriving
    after the oldest pending request has waited ``max_delay_ms``, or a
    ``DecodeTicket.result()`` on a still-pending ticket.

Beside them: ``submit_stream``/``decode_chunks`` decode an asset as
pipelined chunks (the chunk axis, ``engine.plan.chunk_walk_batch``), and
``dispatch_group``/``prepare_group`` are the group backend a scheduler
drives.  Every service carries an :class:`~repro_torch.runtime.
observability.Observability` (per-ticket traces, the launcher profiler of
both sessions, ``metrics``/``metrics_text``) and a fault injector
(``faults=``, :mod:`repro_torch.runtime.faultinject`) whose six service
fault points are no-ops unless armed.

``start_pipeline()`` upgrades the service to the async serving pipeline
(:mod:`repro_torch.runtime.pipeline`): a broker with capability lanes,
adaptive microbatching, admission control, and an ingest worker whose host
work overlaps decode dispatch.  With a broker attached the service is a
thin façade — ``submit``/``submit_stream``/``flush`` route to the broker's
queues and worker threads; ``decode``/``ingest``/``register`` remain
callable from any thread (the service lock and the session locks guard the
shared caches).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from ..core.encode import EncoderSession
from ..core.engine import (ChunkSpec, DecodePlan, DecoderSession,
                           DeviceStream, chunk_walk_batch,
                           concat_walk_batches, pow2_bucket,
                           with_symbol_layout)
from ..core.rans import StaticModel
from ..core.recoil import RecoilPlan, build_split_states, combine_plan
from ..core.vectorized import WalkBatch
from .faultinject import NULL_INJECTOR
from .observability import NULL_TRACE, Observability


@dataclasses.dataclass
class _Content:
    stream: DeviceStream
    plan: RecoilPlan
    final_states: np.ndarray


@dataclasses.dataclass
class ServiceStats:
    """Engine counters + the service's own plan/microbatch accounting."""

    compiles: int
    cache_hits: int
    decodes: int
    plan_hits: int
    plan_misses: int
    coalesced_requests: int
    fused_dispatches: int
    flushes: int
    ingests: int = 0           # contents registered through the encode engine
    extends: int = 0           # incremental re-ingests (suffix-only encodes)
    stream_requests: int = 0   # chunked streaming decodes (submit_stream)
    symbol_plans: int = 0      # requests planned on the symbol-indexed layout
    pointer_plans: int = 0     # requests planned on the pointer-walk fallback

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class DecodeTicket:
    """Handle for a submitted (possibly coalesced) decode request.

    ``trace`` is the ticket's span context — a live
    :class:`~repro_torch.runtime.observability.Trace` on traced paths,
    :data:`NULL_TRACE` for tickets made outside ``submit`` and disabled
    tracing, so dispatch instrumentation never branches on ticket
    provenance.

    ``ready`` is the readiness event the dispatch recorded on the current
    stream right after the launch that produced ``out`` (one event shared
    by a fused group's tickets; None on the CPU).  ``result()`` does not
    wait for it; the pipeline broker does.
    """

    __slots__ = ("_svc", "out", "err", "trace", "ready")

    def __init__(self, svc: "DecodeService"):
        self._svc = svc
        self.out = None
        self.err = None
        self.trace = NULL_TRACE
        self.ready = None

    def _fulfill(self, out=None, err=None) -> None:
        """Dispatch completion hook — the broker's ticket subclass overrides
        this to also release cross-thread waiters and timestamp the
        completion; keep all result delivery going through it."""
        self.out = out
        self.err = err

    def result(self) -> torch.Tensor:
        """The request's device symbol tensor; forces a flush if the fused
        dispatch holding this request has not run yet.  Re-raises the
        dispatch error if the flush holding this request failed."""
        if self.out is None and self.err is None:
            self._svc.flush()
        if self.err is not None:
            raise self.err
        if self.out is None:
            raise RuntimeError("request was never dispatched")
        return self.out


class StreamTicket:
    """Handle for a chunked streaming decode.

    The asset's thinned split rows are partitioned into ``n_chunks``
    completion-ordered chunks (``engine.plan.chunk_walk_batch``); each chunk
    is its own (bucketed, cached) launch, so the first symbols are ready
    after ~1/n_chunks of the asset's decode work instead of all of it.
    ``chunk(i)`` blocks until chunk ``i`` has been launched and returns its
    device symbol tensor (symbols ``base..base+length`` of the asset);
    iterating the ticket yields the chunks in order.  ``result()``
    concatenates them back into the whole asset, on the device.

    Readiness: a launch returns once the kernel is queued, so on the card
    ``dispatch_stream`` records one CUDA event on the current stream right
    after each chunk's launch, and ``synchronize(i)`` waits for chunk ``i``
    alone (on the CPU the chunk is ready when launched).  Timing hooks
    (``submitted_at``/``first_chunk_at``/``completed_at``) are host clocks
    at launch.
    """

    __slots__ = ("n_chunks", "specs", "err", "submitted_at",
                 "first_chunk_at", "completed_at", "_chunks", "_events",
                 "_ready", "trace")

    def __init__(self, n_chunks: int):
        self.n_chunks = n_chunks
        self.specs: list[ChunkSpec] | None = None   # set at dispatch time
        self.err: Exception | None = None
        self.trace = NULL_TRACE
        self.submitted_at = time.perf_counter()
        self.first_chunk_at: float | None = None
        self.completed_at: float | None = None
        self._chunks = [None] * n_chunks
        self._events = [threading.Event() for _ in range(n_chunks)]
        self._ready: list = [None] * n_chunks   # torch.cuda.Event per chunk

    def _fulfill_chunk(self, i: int, out, ready=None) -> None:
        self._chunks[i] = out
        self._ready[i] = ready
        now = time.perf_counter()
        if i == 0:
            self.first_chunk_at = now
        if i == self.n_chunks - 1:
            self.completed_at = now
        self._events[i].set()

    def _fail(self, err: Exception) -> None:
        self.err = err
        for ev in self._events:
            ev.set()

    def chunk(self, i: int, timeout: float | None = None) -> torch.Tensor:
        """Device int32 symbols of chunk ``i`` (launched, possibly still
        running — :meth:`synchronize` waits for it)."""
        if not self._events[i].wait(timeout):
            raise TimeoutError(f"chunk {i} not dispatched within {timeout}s")
        if self.err is not None:
            raise self.err
        return self._chunks[i]

    def synchronize(self, i: int,
                    timeout: float | None = None) -> torch.Tensor:
        """Chunk ``i``'s symbols once the device has written them: waits for
        its launch (as :meth:`chunk`), then for the event recorded after
        it, and for no later chunk."""
        out = self.chunk(i, timeout)
        if self._ready[i] is not None:
            self._ready[i].synchronize()
        return out

    def __iter__(self):
        for i in range(self.n_chunks):
            yield self.chunk(i)

    def result(self) -> torch.Tensor:
        parts = list(self)
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def _launched(out: torch.Tensor):
    """A readiness event recorded on the current stream right after
    ``out``'s launch (None on the CPU, where the launch ran to its end)."""
    if out.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(out.device))
    return ev


class DecodeService:
    """Serve Recoil-encoded content to clients of any parallel capacity.

    One :class:`DecoderSession` per service (one model, one plan cache).
    ``register`` uploads a payload's bitstream to the device once;
    ``decode``/``submit`` thin the split metadata to the request's thread
    count (a pure metadata deletion, paper §3.3) and run the cached
    bucketed launch.  ``device`` defaults to the card (``None`` =
    ``"cuda"``, the Hopper kernels); pass ``device="cpu"`` for the plain
    torch walks.  See the module docstring for the two request paths.
    ``session_kw`` reaches the :class:`DecoderSession` (``layout``,
    ``policy``, ``rows_per_block``, ``packed_lut``, and ``impl="sharded"``
    with ``mesh=``, whose first device is then the service's).

    ``observe=False`` turns the instrumentation off (:data:`NULL_TRACE`
    everywhere, no profiler timing branches; the pull metrics remain).
    ``faults`` is a :class:`~repro_torch.runtime.faultinject.FaultInjector`
    that drives the unhappy paths in tests; the default is the shared
    no-op :data:`~repro_torch.runtime.faultinject.NULL_INJECTOR`.
    """

    # Fused-plan memo bound (FIFO eviction): each entry pins fused device
    # split arrays, so distinct request groups must not accumulate forever.
    MAX_FUSED_PLANS = 256

    def __init__(self, model: StaticModel, *, device=None,
                 microbatch: int = 8, max_delay_ms: float = 50.0,
                 observe: bool = True, trace_capacity: int = 1024,
                 faults=None, **session_kw):
        # Observability first: the decode/encode sessions take its shared
        # profiler at construction.
        self.obs = Observability(enabled=observe,
                                 trace_capacity=trace_capacity)
        self.faults = faults if faults is not None else NULL_INJECTOR
        self.session = DecoderSession(model, device=device,
                                      profiler=self.obs.profiler,
                                      **session_kw)
        self.obs.attach_service(self)
        self.microbatch = int(microbatch)
        self.max_delay_ms = float(max_delay_ms)
        self._encoder: EncoderSession | None = None   # built on first ingest
        self._contents: dict[str, _Content] = {}
        # Content generation counters: bumped on every (re-)registration so
        # downstream memos keyed on content identity can invalidate.
        self._generations: dict[str, int] = {}
        # (name, n_threads) -> prepared request, two granularities: the
        # thinned WalkBatch (fusable) and the full DecodePlan (single path).
        self._batches: dict[tuple, tuple[WalkBatch, int]] = {}
        self._plans: dict[tuple, DecodePlan] = {}
        # (name, n_threads, n_chunks) -> [(DecodePlan, ChunkSpec), ...]:
        # the chunk axis of the streaming path.  Each chunk's plan hits the
        # same bucketed launcher cache as whole-asset requests, so a warm
        # stream is n_chunks cached launches with zero host prep.
        self._chunk_plans: dict[tuple, list] = {}
        # Fused-dispatch memo: a request GROUP that recurs reuses its fused
        # DecodePlan + slice offsets, so a warm flush is one cached launch.
        self._fused_plans: dict[tuple, tuple[DecodePlan, list[int], int]] = {}
        self._pending: list[tuple[DecodeTicket, tuple, WalkBatch, int]] = []
        self._pending_t0 = 0.0
        self._plan_hits = 0
        self._plan_misses = 0
        self._coalesced = 0
        self._fused = 0
        self._flushes = 0
        self._ingests = 0
        self._extends = 0
        self._streams = 0
        # Service lock: guards content/memos/pending/counters.  Reentrant
        # because register() flushes stale pending requests while already
        # holding it.  Launches run outside it, so the broker's ingest and
        # decode workers contend only for the short host-prep sections.
        self._lock = threading.RLock()
        self._broker = None   # attached by start_pipeline()

    def register(self, name: str, plan: RecoilPlan, stream, final_states,
                 *, model=None, emission_log=None) -> None:
        """Register encoded content.  ``stream`` is a raw word array or an
        already-resident :class:`DeviceStream` (never re-uploaded).  The
        content is validated against the service's model before it can
        serve: a mismatched payload raises here instead of silently
        mis-decoding for every client.  Pass ``model`` (the model the
        content was encoded with) to also check the distribution tables.

        ``emission_log`` is the encoder's ``k_of_word`` array (one flat
        symbol index per stream word).  When present, the symbol-indexed
        decode layout is derived on the device at registration — the wire
        bytes are untouched; decode just drops the stream pointer.  Content
        without a log (e.g. parsed off the wire) serves via the pointer
        walk."""
        # Corruption fault point BEFORE validation: an armed corruptor
        # mutates the payload here, and the validation below must reject it
        # loudly — proof that a poisoned container cannot reach serving
        # state.
        stream = self.faults.corrupt("service.register", stream, name=name)
        _validate_content(self.session.model, plan, stream, final_states,
                          enc_model=model)
        with self._lock:
            # Pending requests hold thinned batches of the CURRENT content;
            # dispatch them against it before it is replaced.
            if any(key[0] == name for _, key, _, _ in self._pending):
                self._flush_pending()
            if not isinstance(stream, DeviceStream):
                stream = self.session.upload_stream(stream)
            if emission_log is not None and stream.by_symbol is None:
                stream = with_symbol_layout(stream, emission_log,
                                            plan.n_symbols)
            self._contents[name] = _Content(
                stream=stream, plan=plan,
                final_states=np.asarray(final_states, np.uint32))
            self._generations[name] = self._generations.get(name, 0) + 1
            for cache in (self._batches, self._plans,    # re-registration
                          self._chunk_plans):
                for key in [k for k in cache if k[0] == name]:
                    del cache[key]
            self._fused_plans.clear()

    def generation(self, name: str) -> int:
        """Monotonic per-content registration counter (0 = never seen)."""
        with self._lock:
            return self._generations.get(name, 0)

    def layout_for(self, name: str) -> str:
        """The decode layout this content serves under: ``"symbol"`` when
        its registration carried an emission log, ``"pointer"`` otherwise —
        modulated by the session's layout policy."""
        with self._lock:
            ds = self._contents[name].stream
        return self.session.executor.select_layout(ds)

    def content(self, name: str) -> _Content:
        """The current registered content record (re-registration swaps the
        whole object)."""
        with self._lock:
            return self._contents[name]

    def content_snapshot(self, name: str) -> tuple[int, _Content]:
        """``(generation, content)`` read atomically under the service lock.

        A two-step read — ``generation()`` then ``content()`` — could
        interleave with a concurrent ``extend()`` re-registration and pair
        the OLD generation tag with the NEW bytes (or vice versa).  One lock
        hold makes the pair consistent by construction; derivations tagged
        with this generation are guaranteed to be of these bytes.  Raises
        ``KeyError`` for unregistered names."""
        with self._lock:
            gen = self._generations.get(name, 0)
            if gen == 0:
                raise KeyError(f"content {name!r} is not registered")
            return gen, self._contents[name]

    # ------------------------------------------------------------------
    # Ingest (encode engine -> registration, stream stays on the device)
    # ------------------------------------------------------------------

    def ingest(self, name: str, symbols, n_splits: int) -> RecoilPlan:
        """Encode and split-plan ``symbols`` on the service's device and
        register the result under ``name``; only the split metadata visits
        the host.  Returns the registered :class:`RecoilPlan`."""
        self.faults.fire("service.ingest", name=name)
        res = self._encode_session().ingest(symbols, n_splits, name=name)
        self.register(name, res.plan, res.stream, res.final_states)
        with self._lock:
            self._ingests += 1
        return res.plan

    def extend(self, name: str, delta) -> RecoilPlan:
        """Append ``delta`` symbols to an ingested content and re-register
        the grown asset.  The encoder resumes the rANS state chains from the
        cached final states, so only the suffix is encoded, and the spliced
        stream equals a full re-encode's.  Re-registration bumps the content
        generation and drops its plan memos.  Raises ``KeyError`` when
        ``name`` has no resumable encoder state (fall back to
        :meth:`ingest`)."""
        self.faults.fire("service.extend", name=name)
        res = self._encode_session().extend(name, delta)
        self.register(name, res.plan, res.stream, res.final_states)
        with self._lock:
            self._extends += 1
        return res.plan

    def can_extend(self, name: str) -> bool:
        """Whether :meth:`extend` would find resumable state for ``name``."""
        with self._lock:
            enc = self._encoder
        return enc is not None and enc.can_extend(name)

    def ingest_batch(self, contents: dict, n_splits: int) -> dict:
        """Ingest many contents through one pipeline call:
        ``{name: symbols}`` -> ``{name: RecoilPlan}``."""
        names = list(contents)
        results = self._encode_session().ingest_batch(
            [contents[n] for n in names], n_splits)
        for n, r in zip(names, results):
            self.register(n, r.plan, r.stream, r.final_states)
            with self._lock:
                self._ingests += 1
        return {n: r.plan for n, r in zip(names, results)}

    def _encode_session(self) -> EncoderSession:
        with self._lock:
            if self._encoder is None:
                # A service opted into tuning opts its ingest engine in too
                # (the encoder resolves its OWN profile key — decode
                # ladders never apply to encode group counts).
                self._encoder = EncoderSession(
                    self.session.model, device=self.session.device,
                    policy="tuned" if self.session.tuning_profile is not None
                    else None,
                    profiler=self.obs.profiler)
            return self._encoder

    # ------------------------------------------------------------------
    # Request preparation (memoized per (name, n_threads))
    # ------------------------------------------------------------------

    def _thinned_batch(self, name: str, n_threads: int) -> tuple[WalkBatch, int]:
        """Memoized host prep (caller holds ``_lock``).  Every request
        increments exactly one of ``plan_hits``/``plan_misses`` exactly
        once — a hit means the per-request host preparation was skipped at
        some layer."""
        key = (name, n_threads)
        hit = self._batches.get(key)
        if hit is not None:
            self._plan_hits += 1
            return hit
        self._plan_misses += 1
        c = self._contents[name]
        plan = combine_plan(c.plan, n_threads)
        batch = WalkBatch.from_splits(
            build_split_states(plan, c.final_states), plan.ways)
        self._batches[key] = (batch, plan.n_symbols)
        return self._batches[key]

    # ------------------------------------------------------------------
    # Immediate path
    # ------------------------------------------------------------------

    def prepare_request(self, name: str, n_threads: int) -> DecodePlan:
        """Build (and memoize) the single-request :class:`DecodePlan` for
        ``(name, n_threads)`` without dispatching it.  Identical to the
        host-prep half of :meth:`decode`; both share the memo and the plan
        hit/miss counters."""
        key = (name, n_threads)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                batch, n = self._thinned_batch(name, n_threads)
                plan = self.session.prepare(
                    batch, self._contents[name].stream, n)
                self._plans[key] = plan
            else:
                self._plan_hits += 1
            return plan

    def evict_prepared(self, name: str, n_threads: int) -> bool:
        """Drop the memoized plan + thinned batch for one (name, capability)
        pair (a cache under an entry budget — the pair re-derives
        bit-exactly on its next request).  Returns whether anything was
        dropped."""
        key = (name, int(n_threads))
        with self._lock:
            dropped = self._plans.pop(key, None) is not None
            dropped = (self._batches.pop(key, None) is not None) or dropped
            return dropped

    def decode(self, name: str, n_threads: int) -> torch.Tensor:
        """Decode registered content at the client's parallelism; returns a
        device int32 symbol tensor (no host round-trip)."""
        return self.session.execute(self.prepare_request(name, n_threads))

    # ------------------------------------------------------------------
    # Chunked streaming path
    # ------------------------------------------------------------------

    def _chunked_plans(self, name: str, n_threads: int,
                       n_chunks: int) -> list:
        """Memoized per-chunk plans (caller holds ``_lock``): the request's
        thinned rows partitioned completion-ordered into chunks
        (``chunk_walk_batch``), each prepared as its own bucketed
        :class:`DecodePlan` against the SAME resident stream — chunk ``k``
        only reads the stream-word prefix ``specs[k].words_end``, which is
        what makes decode-while-arriving sound."""
        key = (name, n_threads, int(n_chunks))
        hit = self._chunk_plans.get(key)
        if hit is not None:
            self._plan_hits += 1
            return hit
        batch, n = self._thinned_batch(name, n_threads)
        stream = self._contents[name].stream
        specs = chunk_walk_batch(batch, n, n_chunks)
        plans = [(self.session.prepare(s.batch, stream, s.length), s)
                 for s in specs]
        self._chunk_plans[key] = plans
        return plans

    def stream_chunk_count(self, name: str, n_threads: int,
                           n_chunks: int) -> int:
        """The chunk count a stream request will actually yield
        (``n_chunks`` clamped to the request's split-row count — a chunk
        must hold at least one split row)."""
        with self._lock:
            rows = min(int(n_threads), self._contents[name].plan.n_threads)
        return max(1, min(int(n_chunks), rows))

    def decode_chunks(self, name: str, n_threads: int,
                      n_chunks: int) -> list[torch.Tensor]:
        """Decode registered content as ``n_chunks`` pipelined launches;
        returns the per-chunk device symbol tensors in asset order.  Each
        launch is asynchronous, so chunk 0 is ready after ~1/n_chunks of the
        asset's decode work while later chunks are still running —
        concatenating the parts equals :meth:`decode` exactly."""
        with self._lock:
            self._streams += 1
            plans = self._chunked_plans(name, n_threads, n_chunks)
        return [self.session.execute(p) for p, _ in plans]

    def submit_stream(self, name: str, n_threads: int,
                      n_chunks: int = 8) -> StreamTicket:
        """Chunked streaming decode returning a :class:`StreamTicket` that
        yields per-chunk results as they complete.  With a pipeline broker
        attached the chunks are launched by the broker's decode worker;
        otherwise inline — still pipelined, because each launch is queued
        asynchronously."""
        broker = self._broker
        if broker is not None:
            return broker.submit_stream(name, n_threads, n_chunks)
        ticket = StreamTicket(self.stream_chunk_count(name, n_threads,
                                                      n_chunks))
        ticket.trace = self.obs.tracer.start(
            "stream", name=name, t0=ticket.submitted_at,
            n_threads=n_threads, path="sync")
        ticket.trace.phase("admission")
        return self.dispatch_stream(name, n_threads, n_chunks, ticket)

    def dispatch_stream(self, name: str, n_threads: int, n_chunks: int,
                        ticket: StreamTicket) -> StreamTicket:
        """Plan under the service lock, launch each chunk OUTSIDE it, and
        record each chunk's readiness event.  ``ticket.n_chunks`` must
        equal :meth:`stream_chunk_count` for the request."""
        try:
            self.faults.fire("service.dispatch_stream", name=name)
            with self._lock:
                self._streams += 1
                plans = self._chunked_plans(name, n_threads, n_chunks)
            if len(plans) != ticket.n_chunks:
                raise ValueError(
                    f"ticket expects {ticket.n_chunks} chunks but the plan "
                    f"yields {len(plans)} — content re-registered with "
                    f"fewer splits between submit and dispatch")
            ticket.trace.phase("dispatch", chunks=len(plans))
            ticket.specs = [spec for _, spec in plans]
            for i, (plan, _) in enumerate(plans):
                out = self.session.execute(plan)
                ticket._fulfill_chunk(i, out, _launched(out))
            ticket.trace.phase("execute")
            ticket.trace.finish("ok")
        except Exception as e:
            ticket._fail(e)
            ticket.trace.finish("error", error=repr(e))
            raise
        return ticket

    # ------------------------------------------------------------------
    # Microbatched path
    # ------------------------------------------------------------------

    def submit(self, name: str, n_threads: int, *, deadline=None,
               retries: int = 0) -> DecodeTicket:
        """Queue a request for coalescing (see module docstring for the
        flush policy).  With a pipeline broker attached
        (:meth:`start_pipeline`) the request is queued on the broker's
        capability lanes instead and dispatched by its worker thread;
        ``deadline`` (a class name or an explicit ms budget) then bounds
        its queue wait and ``retries`` opts the ticket into bounded
        transient-fault retry.  The sync path has no lane scheduler or
        retry queue, so its flat ``max_delay_ms`` bound already caps the
        wait and both are accepted but unused."""
        broker = self._broker
        if broker is None:
            with self._lock:
                # Re-check under the lock: a raced start_pipeline() flushed
                # _pending while attaching, so queueing here now would
                # strand the ticket — route to the broker instead.
                broker = self._broker
                if broker is None:
                    now = time.perf_counter()
                    if (self._pending and (now - self._pending_t0) * 1e3
                            > self.max_delay_ms):
                        self._flush_pending()
                    key = (name, n_threads)
                    batch, n = self._thinned_batch(name, n_threads)
                    ticket = DecodeTicket(self)
                    # Spans: admission = host prep at submit time (the
                    # thinning above); the wait until flush is "queue".
                    ticket.trace = self.obs.tracer.start(
                        "decode", name=name, t0=now, n_threads=n_threads,
                        path="sync")
                    ticket.trace.phase("admission")
                    if not self._pending:
                        self._pending_t0 = now
                    self._pending.append((ticket, key, batch, n))
                    if len(self._pending) >= self.microbatch:
                        self._flush_pending()
                    return ticket
        return broker.submit(name, n_threads, deadline=deadline,
                             retries=retries)

    def _flush_pending(self) -> None:
        """Dispatch the sync-path pending queue as one group; on error
        every ticket of the group carries the exception.  No broker
        interaction — safe to call while holding the service lock (e.g.
        from :meth:`register`'s stale-pending guard), where a broker
        ``drain`` could deadlock against workers waiting on that lock."""
        with self._lock:
            reqs, self._pending = self._pending, []
        if not reqs:
            return
        tq = time.perf_counter()
        for ticket, _, _, _ in reqs:
            ticket.trace.phase("queue", tq)
            ticket.trace.phase("coalesce", tq)   # coalesced at submit
        try:
            self._dispatch(reqs)
        except Exception as e:
            for ticket, _, _, _ in reqs:
                ticket._fulfill(err=e)
                ticket.trace.finish("error", error=repr(e))
            raise

    def flush(self) -> None:
        """Dispatch all pending requests as one fused launch.  With a
        broker attached this also drains the broker's queues."""
        self._flush_pending()
        broker = self._broker   # local read: a concurrent stop_pipeline()
        if broker is not None:  # may null the attribute between check/use
            broker.drain()

    def dispatch_group(self, requests, tickets) -> None:
        """Group backend: dispatch ``requests = [(name, n_threads), ...]``
        as one fused launch, fulfilling ``tickets`` positionally.

        Unlike :meth:`submit`, the thinned batches are built HERE — at
        dispatch time, under the service lock — so a group formed while
        content is re-registered can never mix one request's old split
        metadata with another's new stream: every request in the group is
        prepared against one consistent content snapshot.  Registration is
        checked ONCE per distinct name at group build, under the same lock
        hold that builds the batches (see :meth:`content_snapshot`).  On
        any error every ticket carries it."""
        try:
            if len(requests) != len(tickets):
                # Tickets fulfill positionally: a silent zip over mismatched
                # lengths would strand the surplus tickets forever — fail
                # the WHOLE group loudly so every ticket carries the error.
                raise ValueError(
                    f"dispatch_group got {len(requests)} requests but "
                    f"{len(tickets)} tickets — they must align positionally")
            self.faults.fire("service.dispatch_group",
                             names=[name for name, _ in requests])
            with self._lock:
                missing = sorted({
                    name for name, _ in requests
                    if self._generations.get(name, 0) == 0})
                if missing:
                    raise KeyError(
                        f"content not registered: {', '.join(missing)}")
                reqs = []
                for ticket, (name, n_threads) in zip(tickets, requests):
                    batch, n = self._thinned_batch(name, n_threads)
                    reqs.append((ticket, (name, n_threads), batch, n))
        except Exception as e:
            for ticket in tickets:
                ticket._fulfill(err=e)
                if not getattr(ticket, "_retry_pending", False):
                    ticket.trace.finish("error", error=repr(e))
            raise
        tc = time.perf_counter()
        for ticket in tickets:
            ticket.trace.phase("coalesce", tc)
        try:
            self._dispatch(reqs)
        except Exception as e:
            for ticket, _, _, _ in reqs:
                ticket._fulfill(err=e)
                # A broker ticket with retries left parks as retry-pending
                # instead of completing; its trace stays open for the retry
                # attempt (the broker records a "retry" event and the
                # terminal pass finishes it).
                if not getattr(ticket, "_retry_pending", False):
                    ticket.trace.finish("error", error=repr(e))
            raise

    def prepare_group(self, requests) -> DecodePlan:
        """Build (and memoize) the fused :class:`DecodePlan` a request group
        ``[(name, n_threads), ...]`` would dispatch, WITHOUT launching it.

        A warmer's probe: pairing this with ``session.is_compiled(plan)``
        finds the group shapes whose launcher is not resolved yet.  Returns
        the plan only — tickets and output slicing stay with
        :meth:`dispatch_group` — and counts no dispatch."""
        reqs = []
        with self._lock:
            for name, n_threads in requests:
                if self._generations.get(name, 0) == 0:
                    raise KeyError(f"content {name!r} is not registered")
                batch, n = self._thinned_batch(name, n_threads)
                reqs.append((None, (name, n_threads), batch, n))
            plan, _sym_off = self._group_plan(reqs, record=False)
        return plan

    def _group_plan(self, reqs, record: bool = True):
        """Resolve the (memoized) plan for a built request group.  Caller
        holds ``_lock``.  MUTATES ``reqs`` into canonical order (the fused
        layout is arrival-order independent, so any permutation of the same
        group shares one memo entry; tickets travel with their request).
        ``record=False`` skips the dispatch counters (probes must not
        inflate ``fused_dispatches``)."""
        if len(reqs) == 1:
            _, key, batch, n = reqs[0]
            plan = self._plans.get(key)
            if plan is None:
                plan = self.session.prepare(
                    batch, self._contents[key[0]].stream, n)
                self._plans[key] = plan
            return plan, None
        if record:
            self._fused += 1
            self._coalesced += len(reqs)
        reqs.sort(key=lambda r: r[1])
        group = tuple(key for _, key, _, _ in reqs)
        hit = self._fused_plans.get(group)
        if hit is None:
            if len(self._fused_plans) >= self.MAX_FUSED_PLANS:
                self._fused_plans.pop(next(iter(self._fused_plans)))
            plan, sym_off, total = self._prepare_fused(reqs)
            self._fused_plans[group] = (plan, sym_off, total)
        else:
            plan, sym_off, total = hit
        return plan, sym_off

    def _dispatch(self, reqs) -> None:
        """Plan under the service lock; launch outside it, and record the
        launch's readiness event (``DecodeTicket.ready``) right after it.

        Span marks: plan resolution closes "dispatch", the launch closes
        "execute", fulfillment closes "delivery".  On the broker path the
        worker waits for the group's output anyway, so for traced groups
        the wait moves here, inside the execute span.  The sync path stays
        asynchronous: its execute span is the host-side enqueue cost and
        the caller owns the device wait (a traced flush that synchronized
        would charge instrumentation for a wait the untraced path never
        does)."""
        with self._lock:
            self._flushes += 1
            plan, sym_off = self._group_plan(reqs)
        traces = [t.trace for t, _, _, _ in reqs]
        tp = time.perf_counter()
        for tr in traces:
            tr.phase("dispatch", tp)
        self.faults.fire("service.execute", group=len(reqs))
        out = self.session.execute(plan)
        ready = _launched(out)
        if (ready is not None and self._broker is not None
                and any(tr.live for tr in traces)):
            ready.synchronize()
        tx = time.perf_counter()
        for tr in traces:
            tr.phase("execute", tx, group=len(reqs))
        # Per-ticket finish, right after the ticket's own fulfillment,
        # stamped at the ticket's own completion time when it records one
        # (the broker's tickets): each trace's span-sum then equals its own
        # end-to-end latency.
        if sym_off is None:
            ticket = reqs[0][0]
            ticket.ready = ready
            ticket._fulfill(out=out)
            td = getattr(ticket, "completed_at", None) or time.perf_counter()
            ticket.trace.phase("delivery", td)
            ticket.trace.finish("ok", td)
            return
        for (ticket, _, _, n), off in zip(reqs, sym_off):
            ticket.ready = ready
            ticket._fulfill(out=out[off:off + n])
            if ticket.trace.live:
                td = getattr(ticket, "completed_at", None) \
                    or time.perf_counter()
                ticket.trace.phase("delivery", td)
                ticket.trace.finish("ok", td)

    def _prepare_fused(self, reqs) -> tuple[DecodePlan, list[int], int]:
        streams: dict[int, DeviceStream] = {}
        for _, key, _, _ in reqs:
            ds = self._contents[key[0]].stream
            streams.setdefault(id(ds), ds)
        if len(streams) == 1:
            fused_ds = next(iter(streams.values()))
            word_off = {id(fused_ds): 0}
            perm_off = {id(fused_ds): 0}
        else:
            fused_ds, word_off, perm_off = _fuse_streams(
                list(streams.values()))
        sym_off, total = [], 0
        for _, _, _, n in reqs:
            sym_off.append(total)
            total += n
        fused = concat_walk_batches(
            [b for _, _, b, _ in reqs], sym_off,
            [word_off[id(self._contents[key[0]].stream)]
             for _, key, _, _ in reqs],
            [perm_off[id(self._contents[key[0]].stream)]
             for _, key, _, _ in reqs])
        return self.session.prepare(fused, fused_ds, total), sym_off, total

    # ------------------------------------------------------------------
    # Async serving pipeline (runtime.pipeline)
    # ------------------------------------------------------------------

    def start_pipeline(self, **broker_kw):
        """Attach a :class:`~repro_torch.runtime.pipeline.PipelineBroker`
        and become its thin façade: ``submit``/``submit_stream``/``flush``
        route through the broker's capability lanes and worker threads.
        Returns the broker (also a context manager)."""
        from .pipeline import PipelineBroker
        with self._lock:
            if self._broker is not None:
                raise RuntimeError("pipeline already running; stop it first")
            # Requests queued through the sync path before the upgrade must
            # dispatch NOW: once the broker is attached, flush() routes to
            # broker.drain() and would never touch them.
            self._flush_pending()
            self._broker = PipelineBroker(self, **broker_kw)
        return self._broker

    def stop_pipeline(self) -> None:
        """Drain and detach the broker (no-op when none is attached)."""
        with self._lock:
            broker, self._broker = self._broker, None
        if broker is not None:
            broker.close()

    @property
    def broker(self):
        return self._broker

    @property
    def tuning_profile(self):
        """The tuned :class:`~repro_torch.core.tuning.Profile` the decode
        session resolved (None = legacy ladder).  The pipeline broker reads
        the profile's microbatch quantization sizes so the warmed shape set
        matches what dispatch actually requests."""
        return self.session.tuning_profile

    def metrics(self) -> dict:
        """The unified metrics snapshot (native instruments + every
        collector) — see ``repro_torch.runtime.observability.SCHEMA``."""
        return self.obs.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of :meth:`metrics`."""
        return self.obs.exposition()

    @property
    def stats(self) -> ServiceStats:
        e = self.session.stats
        plans = self.session.executor.layout_plans
        with self._lock:
            return ServiceStats(
                compiles=e.compiles, cache_hits=e.cache_hits,
                decodes=e.decodes,
                plan_hits=self._plan_hits, plan_misses=self._plan_misses,
                coalesced_requests=self._coalesced,
                fused_dispatches=self._fused, flushes=self._flushes,
                ingests=self._ingests, extends=self._extends,
                stream_requests=self._streams,
                symbol_plans=plans["symbol"], pointer_plans=plans["pointer"])


def _validate_content(model: StaticModel, plan: RecoilPlan, stream,
                      final_states, enc_model=None) -> None:
    """Loud registration-time validation (a mismatched payload would decode
    to silent garbage for every client — fail here instead).

    Checks everything derivable from the metadata: way count, stream/plan
    word-count agreement, final-state shape and the rANS state invariant
    (``L <= x < 2^32``), and the plan's own split invariants.  When the
    caller supplies the model the content was *encoded* with, the
    distribution tables and params are compared against the service model
    too (the one mismatch pure metadata cannot reveal)."""
    p = model.params
    if plan.ways != p.ways:
        raise ValueError(
            f"content was planned for {plan.ways}-way interleaving but the "
            f"service model uses ways={p.ways}")
    n_words = (stream.n_words if isinstance(stream, DeviceStream)
               else len(stream))
    if n_words != plan.n_words:
        raise ValueError(
            f"stream has {n_words} words but the plan says "
            f"{plan.n_words} — truncated or mismatched payload")
    fs = np.asarray(final_states)
    if fs.shape != (p.ways,):
        raise ValueError(
            f"final_states shape {fs.shape} != (ways,) = ({p.ways},)")
    if fs.size and (int(fs.min()) < p.lower_bound
                    or int(fs.max()) >= 2 ** 32):
        raise ValueError(
            "final states violate the rANS invariant L <= x < 2^32 — "
            "content was not produced by a compatible encoder")
    plan.validate(p.lower_bound)
    if enc_model is not None:
        q = enc_model.params
        if (q.n_bits, q.ways) != (p.n_bits, p.ways):
            raise ValueError(
                f"content encoded with n_bits={q.n_bits}, ways={q.ways}; "
                f"service model has n_bits={p.n_bits}, ways={p.ways}")
        if (np.asarray(enc_model.f).shape != np.asarray(model.f).shape
                or not np.array_equal(enc_model.f, model.f)):
            raise ValueError(
                "content was encoded with a different distribution table "
                "than the service model — it would mis-decode")


def _fuse_permutations(streams: list[DeviceStream]) -> tuple:
    """Concatenate ``words_by_symbol`` permutations for a fused dispatch.

    Sym-bucket-aligned (like the word fusion), so per-request ``sym_base``
    shifts are exact AND stay multiples of ``ways`` (buckets are pow2 >=
    1024).  Any stream without a permutation downgrades the whole fused
    group to the pointer walk — layouts never mix inside one launch.
    Returns ``(by_symbol | None, sym_bucket, perm_off)``.
    """
    perm_off: dict[int, int] = {}
    total = 0
    for ds in streams:
        perm_off[id(ds)] = total
        total += ds.sym_bucket
    if any(ds.by_symbol is None for ds in streams):
        return None, 0, {id(ds): 0 for ds in streams}
    bucket = pow2_bucket(total, 1024)
    # Entries are 16-bit stream words, not offsets, so the fused permutation
    # stays u16 (int16 bit patterns) however long the group is.
    parts = [ds.by_symbol for ds in streams]
    dev = streams[0].words.device
    if bucket > total:
        parts.append(torch.zeros(bucket - total, dtype=torch.int16,
                                 device=dev))
    return torch.cat(parts), bucket, perm_off


def _fuse_streams(streams: list[DeviceStream]) -> tuple[DeviceStream, dict,
                                                       dict]:
    """Concatenate resident streams for a cross-content fused dispatch, on
    the device.

    Layout preserves each stream's padded bucket window, so word offsets are
    bucket-aligned and the per-request ``q0`` shift is exact.  Symbol-layout
    permutations fuse alongside (:func:`_fuse_permutations`); returns
    ``(fused, word_off, perm_off)``.
    """
    word_off: dict[int, int] = {}
    total = 0
    for ds in streams:
        word_off[id(ds)] = total
        total += ds.bucket
    bucket = pow2_bucket(total, 1024)
    by_symbol, sym_bucket, perm_off = _fuse_permutations(streams)
    parts = [ds.words for ds in streams]
    if bucket > total:
        parts.append(torch.zeros(bucket - total, dtype=torch.int16,
                                 device=streams[0].words.device))
    fused = DeviceStream(words=torch.cat(parts), host=None, n_words=total,
                         bucket=bucket, by_symbol=by_symbol,
                         sym_bucket=sym_bucket)
    return fused, word_off, perm_off
