"""Content-delivery decode service.

``DecodeService`` is the rANS side of serving: encoded payloads registered
once (stream resident on the device), split metadata thinned per request to
the client's parallelism, and every decode dispatched through a persistent
:class:`repro_torch.core.engine.DecoderSession`, so steady-state traffic
re-resolves nothing.  Content enters pre-encoded through ``register``,
validated against the service model before it can serve.  Two request
paths:

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
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from ..core.engine import (DecodePlan, DecoderSession, DeviceStream,
                           concat_walk_batches, pow2_bucket,
                           with_symbol_layout)
from ..core.rans import StaticModel
from ..core.recoil import RecoilPlan, build_split_states, combine_plan
from ..core.vectorized import WalkBatch


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
    symbol_plans: int = 0      # requests planned on the symbol-indexed layout
    pointer_plans: int = 0     # requests planned on the pointer-walk fallback

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class DecodeTicket:
    """Handle for a submitted (possibly coalesced) decode request."""

    __slots__ = ("_svc", "out", "err")

    def __init__(self, svc: "DecodeService"):
        self._svc = svc
        self.out = None
        self.err = None

    def _fulfill(self, out=None, err=None) -> None:
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


class DecodeService:
    """Serve Recoil-encoded content to clients of any parallel capacity.

    One :class:`DecoderSession` per service (one model, one plan cache).
    ``register`` uploads a payload's bitstream to the device once;
    ``decode``/``submit`` thin the split metadata to the request's thread
    count (a pure metadata deletion, paper §3.3) and run the cached
    bucketed launch.  ``device`` defaults to ``"cuda"`` (the Hopper
    kernels); pass ``device="cpu"`` for the plain torch walks.  See the
    module docstring for the two request paths.
    """

    # Fused-plan memo bound (FIFO eviction): each entry pins fused device
    # split arrays, so distinct request groups must not accumulate forever.
    MAX_FUSED_PLANS = 256

    def __init__(self, model: StaticModel, *, device="cuda",
                 microbatch: int = 8, max_delay_ms: float = 50.0,
                 **session_kw):
        self.session = DecoderSession(model, device=device, **session_kw)
        self.microbatch = int(microbatch)
        self.max_delay_ms = float(max_delay_ms)
        self._contents: dict[str, _Content] = {}
        # Content generation counters: bumped on every (re-)registration so
        # downstream memos keyed on content identity can invalidate.
        self._generations: dict[str, int] = {}
        # (name, n_threads) -> prepared request, two granularities: the
        # thinned WalkBatch (fusable) and the full DecodePlan (single path).
        self._batches: dict[tuple, tuple[WalkBatch, int]] = {}
        self._plans: dict[tuple, DecodePlan] = {}
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
        # Service lock: guards content/memos/pending/counters.  Reentrant
        # because register() flushes stale pending requests while already
        # holding it.  Launches run outside it.
        self._lock = threading.RLock()

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
            for cache in (self._batches, self._plans):   # re-registration
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

    def decode(self, name: str, n_threads: int) -> torch.Tensor:
        """Decode registered content at the client's parallelism; returns a
        device int32 symbol tensor (no host round-trip)."""
        return self.session.execute(self.prepare_request(name, n_threads))

    # ------------------------------------------------------------------
    # Microbatched path
    # ------------------------------------------------------------------

    def submit(self, name: str, n_threads: int) -> DecodeTicket:
        """Queue a request for coalescing (see module docstring for the
        flush policy)."""
        with self._lock:
            now = time.perf_counter()
            if self._pending and \
                    (now - self._pending_t0) * 1e3 > self.max_delay_ms:
                self._flush_pending()
            key = (name, n_threads)
            batch, n = self._thinned_batch(name, n_threads)
            ticket = DecodeTicket(self)
            if not self._pending:
                self._pending_t0 = now
            self._pending.append((ticket, key, batch, n))
            if len(self._pending) >= self.microbatch:
                self._flush_pending()
            return ticket

    def _flush_pending(self) -> None:
        """Dispatch the pending queue as one group; on error every ticket
        of the group carries the exception."""
        with self._lock:
            reqs, self._pending = self._pending, []
        if not reqs:
            return
        try:
            self._dispatch(reqs)
        except Exception as e:
            for ticket, _, _, _ in reqs:
                ticket._fulfill(err=e)
            raise

    def flush(self) -> None:
        """Dispatch all pending requests as one fused launch."""
        self._flush_pending()

    def _group_plan(self, reqs):
        """Resolve the (memoized) plan for a built request group.  Caller
        holds ``_lock``.  MUTATES ``reqs`` into canonical order (the fused
        layout is arrival-order independent, so any permutation of the same
        group shares one memo entry; tickets travel with their request)."""
        if len(reqs) == 1:
            _, key, batch, n = reqs[0]
            plan = self._plans.get(key)
            if plan is None:
                plan = self.session.prepare(
                    batch, self._contents[key[0]].stream, n)
                self._plans[key] = plan
            return plan, None
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
        """Plan under the service lock; launch outside it."""
        with self._lock:
            self._flushes += 1
            plan, sym_off = self._group_plan(reqs)
        out = self.session.execute(plan)
        if sym_off is None:
            reqs[0][0]._fulfill(out=out)
            return
        for (ticket, _, _, n), off in zip(reqs, sym_off):
            ticket._fulfill(out=out[off:off + n])

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
    # Small streams store the permutation as u16; a fused group's offsets
    # can exceed 2^16, so fusion upcasts every part to the common u32 width
    # (int32 bit patterns: a u16 part widens with its sign bit cleared).
    parts = [ds.by_symbol.to(torch.int32) & 0xFFFF
             if ds.by_symbol.dtype == torch.int16 else ds.by_symbol
             for ds in streams]
    dev = streams[0].words.device
    if bucket > total:
        parts.append(torch.zeros(bucket - total, dtype=torch.int32,
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
        parts.append(torch.zeros(bucket - total, dtype=torch.int32,
                                 device=streams[0].words.device))
    fused = DeviceStream(words=torch.cat(parts), host=None, n_words=total,
                         bucket=bucket, by_symbol=by_symbol,
                         sym_bucket=sym_bucket)
    return fused, word_off, perm_off
