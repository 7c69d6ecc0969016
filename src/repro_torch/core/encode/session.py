"""EncoderSession: the ingest engine, symbols in, device-resident content out.

Counterpart of the JAX package's ``EncoderSession``.  The session owns:

  * the device-resident frequency tables, uploaded once at construction
    (static ``[A]`` or adaptive ``[C, A]``), and the encoder records its
    executor builds from them once, for every encode it runs;
  * the resume LRU that :meth:`extend` reads;
  * request accounting (:class:`EncodeStats`).

``ingest`` is the device-resident path: symbols -> (DeviceStream, RecoilPlan,
final states) with only the split metadata and a few scalars visiting the
host — the stream feeds :meth:`repro_torch.runtime.serve.DecodeService.
register` directly.  ``encode`` materializes a host :class:`EncodedStream`
(the oracle-compatible object).  ``ingest_batch`` runs B contents through
one pipeline call.

The kernels take their sizes at run time, so unlike the reference there is
no executable cache, no compile count and no fast/full tier: every request
runs the oracle-complete planner once.  An injected profiler therefore gets
run records only, never an encode compile record.

Thread model: ``_lock`` guards the stats and the resume LRU; the pipeline
runs outside it on request-local data.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
import torch

from ...device import resolve_device
from ..engine.plan import DeviceStream, pow2_bucket
from ..interleaved import EncodedStream
from ..recoil import RecoilPlan, SplitPoint
from .executors import EncodeExecutor
from .plan import EncodePlan

# A content's symbols, below 2^31 - 2^26.  The kernels index their grids
# in int32 (their wrappers refuse 2^31 slots or more) and form no product
# of a symbol count in int; the planner's chain forms N + n_splits in int32,
# and its wrapper refuses 2^26 split slots or more.  (The reference stops
# at 2^30, so that 2 N does not wrap in its int32 device arithmetic.)
MAX_SYMBOLS = (1 << 31) - (1 << 26)


@dataclasses.dataclass
class EncodeStats:
    encodes: int = 0       # pipeline dispatches (a batch counts as one)
    extends: int = 0       # incremental re-ingests (suffix-only encodes)
    resume_evictions: int = 0   # LRU-evicted resumable tails

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _ResumeState:
    """Per-name tail of the last ingest: everything ``extend`` resumes from.
    ``final_states`` seed the suffix encode; the stream and plan are the
    registered content the splice appends to."""

    n_symbols: int
    final_states: np.ndarray     # uint32[W]
    stream: DeviceStream
    plan: RecoilPlan


@dataclasses.dataclass(frozen=True)
class IngestResult:
    """One ingested content: everything ``DecodeService.register`` needs.

    ``stream.words`` is the device-resident padded word array (``host`` is
    None — the bitstream never visited the host) and ``stream.by_symbol``
    its symbol-indexed permutation; ``plan`` carries the Definition-4.1 split
    metadata, already validated.
    """

    stream: DeviceStream
    plan: RecoilPlan
    final_states: np.ndarray   # uint32[W]
    n_words: int


def _host_u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32).copy()


class EncoderSession:
    """Device-resident Recoil ingest engine.

    ``model`` is a :class:`~repro_torch.core.rans.StaticModel` or a
    :class:`~repro_torch.core.adaptive.ContextModel` (adaptive, index-keyed
    distributions; pass the per-symbol ``ctx`` map to each request, or rely
    on ``model.ctx`` when it covers the content).  ``device`` defaults to
    ``"cuda"`` (the Hopper kernels) and raises without a card; pass
    ``device="cpu"`` for the plain torch versions.  ``window`` is the
    Def-4.1 candidate half-window (it must match the oracle's to stay
    bit-exact).

    ``policy`` resolves the ingest's own bucket ladder, with the
    :class:`~repro_torch.core.engine.session.DecoderSession` contract
    (``None`` = legacy unless ``REPRO_TUNING_DB`` is set,
    ``"tuned"``/``"legacy"``, a ``BucketPolicy`` or a tuning ``Profile``)
    under its own profile key, layout ``"encode"`` (``cuda:cuda:encode`` on
    the card, ``cpu:torch:encode`` on the CPU), exposed as :attr:`policy`
    and :attr:`tuning_profile`.  The ingest kernels take their sizes at run
    time and the session keeps no executable cache, so no encode dimension
    is padded by the policy: it is resolved and reported, as the
    reference's is, and shapes nothing here.

    ``resume_capacity`` bounds the per-name resumable-tail map that
    :meth:`extend` reads: least-recently-used tails beyond it are evicted
    (``stats.resume_evictions``) and later extends of those names raise
    ``KeyError`` (the caller falls back to a full re-ingest).

    ``profiler`` is an injected per-plan-key timer (duck-typed — see
    ``repro_torch.runtime.observability.ExecProfiler``); None keeps
    :meth:`execute` free of timing branches.
    """

    def __init__(self, model, *, device="cuda", window: int = 96,
                 policy=None, resume_capacity: int = 64, profiler=None):
        self.device = resolve_device(device)
        self.profiler = profiler
        from ..tuning import resolve_policy
        self.policy, self.tuning_profile = resolve_policy(
            policy, impl="cuda" if self.device.type == "cuda" else "torch",
            layout="encode")
        self.model = model
        self.adaptive = np.asarray(model.f).ndim == 2
        self.params = model.params
        f = np.asarray(model.f).astype(np.int32)
        F = np.asarray(model.F).astype(np.int32)
        self.alphabet = f.shape[-1]
        self.executor = EncodeExecutor(
            torch.as_tensor(f, device=self.device),
            torch.as_tensor(F, device=self.device), n_bits=self.params.n_bits,
            ways=self.params.ways, adaptive=self.adaptive, window=window)
        if resume_capacity < 1:
            raise ValueError("resume_capacity must be >= 1")
        self.resume_capacity = resume_capacity
        self._lock = threading.Lock()   # guards stats + _resume
        # LRU of resumable tails, most-recent last.
        self._resume: collections.OrderedDict[str, _ResumeState] = \
            collections.OrderedDict()
        self.stats = EncodeStats()

    # ------------------------------------------------------------------
    # Prepare / execute
    # ------------------------------------------------------------------

    def prepare(self, symbols, n_splits: int = 1, ctx=None) -> EncodePlan:
        """Request preparation only (no dispatch): upload, check, lay out
        the grids.  The returned plan may be re-executed."""
        if n_splits < 1:
            raise ValueError("need at least one decoder thread")
        syms = self._symbols(symbols)
        return self.executor.plan(
            syms, int(n_splits), self._ctx(self._ctx_for(syms.numel(), ctx)))

    def prepare_batch(self, contents, n_splits, ctxs=None) -> EncodePlan:
        syms = [self._symbols(c) for c in contents]
        if ctxs is None and self.adaptive:
            ctxs = [self._ctx_for(s.numel(), None) for s in syms]
        elif ctxs is not None and not self.adaptive:
            raise ValueError("ctx maps given but the model is static")
        return self.executor.plan_batch(
            syms, n_splits, None if ctxs is None else
            [self._ctx(c) for c in ctxs])

    def execute(self, plan: EncodePlan) -> dict:
        """Run a prepared plan through the ingest pipeline, run-timed under
        ``plan.key`` when profiled.  The pipeline reads its word counts on
        the host midway, so a run time covers the encode on the device and
        the planner's enqueue."""
        with self._lock:
            self.stats.encodes += 1
        prof = self.profiler
        if prof is None:
            return self.executor.run(plan)
        t0 = prof.now()
        out = self.executor.run(plan)
        prof.record_run("encode", plan.key, prof.now() - t0)
        return out

    # ------------------------------------------------------------------
    # Ingest (device-resident) / encode (host materialization)
    # ------------------------------------------------------------------

    def ingest(self, symbols, n_splits: int, ctx=None,
               name: str | None = None) -> IngestResult:
        """symbols -> (device stream, validated RecoilPlan, final states).

        The stream never visits the host; the returned handle plugs into
        ``DecodeService.register`` and any ``DecoderSession`` on the same
        device.  Passing ``name`` records the resumable tail so later
        :meth:`extend` calls can re-ingest only a delta.
        """
        plan = self.prepare(symbols, n_splits, ctx)
        out = self.execute(plan)
        res = self._materialize(out, 0, plan.n_symbols, symbols)
        if name is not None:
            self._remember(name, res)
        return res

    def ingest_batch(self, contents, n_splits,
                     ctxs=None) -> list[IngestResult]:
        """B contents through one pipeline call; per-content results."""
        plan = self.prepare_batch(contents, n_splits, ctxs)
        out = self.execute(plan)
        sizes = plan.args[4].tolist()       # each content's n_symbols
        return [self._materialize(out, i, sizes[i], c)
                for i, c in enumerate(contents)]

    def ingest_container(self, symbols, n_splits: int) -> tuple:
        """Ingest one content of a static model and pack it into the wire
        container (``container.pack_recoil``).  Only the stream's words,
        the final states and the split plan cross to the host.  Returns
        ``(container bytes, RecoilPlan)``."""
        from .. import container
        res = self.ingest(symbols, n_splits)
        words = res.stream.words[:res.n_words].cpu().numpy().view(np.uint16)
        enc = EncodedStream(stream=words, final_states=res.final_states,
                            n_symbols=res.plan.n_symbols, params=self.params,
                            k_of_word=None, y_of_word=None)
        return container.pack_recoil(enc, self.model, res.plan), res.plan

    def encode(self, symbols, ctx=None) -> EncodedStream:
        """Host :class:`EncodedStream` (stream + emission log), bit-exact
        against ``interleaved.encode_interleaved``."""
        plan = self.prepare(symbols, 1, ctx)
        out = self.execute(plan)
        self._check_flags(out, 0, symbols)
        n = out["n_words"][0]
        return EncodedStream(
            stream=out["stream"][0, :n].cpu().numpy().view(np.uint16).copy(),
            final_states=_host_u32(out["final_states"][0]),
            n_symbols=plan.n_symbols, params=self.params,
            k_of_word=out["k_of_word"][0, :n].cpu().numpy().astype(np.int64),
            y_of_word=_host_u32(out["y_of_word"][0, :n]))

    # ------------------------------------------------------------------
    # Incremental re-ingest
    # ------------------------------------------------------------------

    def _remember(self, name: str, res: IngestResult) -> None:
        with self._lock:
            self._resume[name] = _ResumeState(
                n_symbols=res.plan.n_symbols,
                final_states=np.asarray(res.final_states),
                stream=res.stream, plan=res.plan)
            self._resume.move_to_end(name)
            while len(self._resume) > self.resume_capacity:
                self._resume.popitem(last=False)
                self.stats.resume_evictions += 1

    def can_extend(self, name: str) -> bool:
        with self._lock:
            return name in self._resume

    def forget(self, name: str) -> None:
        """Drop the resumable tail (callers fall back to full re-ingest)."""
        with self._lock:
            self._resume.pop(name, None)

    def extend(self, name: str, delta, ctx=None) -> IngestResult:
        """Append ``delta`` to the content last ingested (or extended) under
        ``name``, encoding only the suffix.

        Each way's chain resumes from the cached ``final_states`` (a way's
        chain depends only on its own symbols, so the suffix emissions equal
        a full re-encode's), then the stream words, split points and
        permutation entries are spliced after the registered ones.  Raises
        ``KeyError`` when ``name`` has no resumable tail.
        """
        with self._lock:
            state = self._resume.get(name)
            if state is not None:
                self._resume.move_to_end(name)   # touch: extend = recent use
        if state is None:
            raise KeyError(
                f"no resumable ingest state for {name!r}; fall back to a "
                "full ingest (pass name= to ingest to record the tail)")
        d_syms = self._symbols(delta)
        d = d_syms.numel()
        if d == 0:
            raise ValueError("extend needs a non-empty delta")
        N0 = state.n_symbols
        if N0 + d >= MAX_SYMBOLS:
            raise ValueError(
                f"extended content ({N0} + {d} symbols) exceeds the int32 "
                f"device planning range (< {MAX_SYMBOLS})")
        W = self.params.ways
        head = N0 % W
        # Keep split density: the registered plan placed M0 points over N0
        # symbols, so the suffix gets ~M0 * d / N0 new ones (>= 0).
        m0 = state.plan.n_threads - 1
        n_splits = 1 + (-(-m0 * d // N0) if N0 else m0)
        plan = self.executor.plan_extend(
            d_syms, n_splits, head, state.final_states,
            self._ctx(self._ctx_for(d, ctx, offset=N0)))
        out = self.execute(plan)
        with self._lock:
            self.stats.extends += 1
        res = self._materialize_extend(out, state, delta, d, head)
        self._remember(name, res)
        return res

    def _materialize_extend(self, out, state: _ResumeState, delta, d: int,
                            head: int) -> IngestResult:
        """Splice the suffix pipeline's outputs onto the registered content.
        Suffix emissions follow every old one in (g, j) order, so each array
        splices by concatenation: offsets rebase by the old word count,
        symbols by the suffix grid's origin ``N_old - head``.  The suffix's
        ``head`` lead entries stand for old symbols and are dropped."""
        self._check_flags(out, 0, delta)
        W = self.params.ways
        N0 = state.n_symbols
        n_total = N0 + d
        origin = N0 - head
        old_n = state.stream.n_words
        suffix_n = out["n_words"][0]
        n_words = old_n + suffix_n
        q, k, y = self._points(out, 0)
        new_points = tuple(
            SplitPoint(offset=int(qm) + old_n, k=km + origin, y=ym)
            for qm, km, ym in zip(q, k, y))
        rplan = RecoilPlan(points=state.plan.points + new_points,
                           n_symbols=n_total, n_words=n_words, ways=W)
        rplan.validate(self.params.lower_bound)

        dev = self.device
        bucket = pow2_bucket(n_words, 1024)
        words = torch.zeros(bucket, dtype=torch.int16, device=dev)
        words[:old_n] = state.stream.words[:old_n]
        words[old_n:n_words] = out["stream"][0, :suffix_n]
        sym_bucket = pow2_bucket(n_total, 1024)
        by = torch.zeros(sym_bucket, dtype=torch.int16, device=dev)
        by[:N0] = state.stream.by_symbol[:N0]
        by[N0:n_total] = out["by_symbol"][0, head:head + d]
        ds = DeviceStream(words=words, host=None, n_words=n_words,
                          bucket=bucket, by_symbol=by, sym_bucket=sym_bucket)
        return IngestResult(stream=ds, plan=rplan,
                            final_states=_host_u32(out["final_states"][0]),
                            n_words=n_words)

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    def _symbols(self, symbols) -> torch.Tensor:
        """A content as a 1-D int32 tensor on the session's device, checked
        against the planning range and the model's alphabet."""
        if not torch.is_tensor(symbols):
            a = np.asarray(symbols)
            if a.dtype.kind == "u" and a.dtype.itemsize > 1:
                a = a.astype(np.int64)   # torch lacks ops on wide unsigned
            symbols = torch.as_tensor(a)
        if symbols.is_floating_point() or symbols.is_complex():
            raise ValueError("symbols must be integers")
        t = symbols.reshape(-1)
        if t.numel() >= MAX_SYMBOLS:
            raise ValueError(
                f"n_symbols={t.numel()} exceeds the int32 device planning "
                f"range (< {MAX_SYMBOLS})")
        t = t.to(self.device)
        if t.numel():
            lo, hi = torch.stack(
                [t.min().long(), t.max().long()]).tolist()
            if lo < 0 or hi >= self.alphabet:
                raise ValueError(
                    f"symbols outside the model alphabet [0, "
                    f"{self.alphabet}): min {lo}, max {hi}")
        return t.to(torch.int32)

    def _ctx(self, ctx) -> torch.Tensor | None:
        if ctx is None:
            return None
        return torch.as_tensor(np.asarray(ctx) if not torch.is_tensor(ctx)
                               else ctx).reshape(-1).to(self.device,
                                                        torch.int32)

    def _ctx_for(self, n: int, ctx, offset: int = 0):
        """The context map of symbols ``[offset, offset + n)``: ``ctx`` as
        given, else the model's own map when it covers them."""
        if not self.adaptive:
            if ctx is not None:
                raise ValueError("ctx map given but the model is static")
            return None
        if ctx is not None:
            return ctx
        model_ctx = getattr(self.model, "ctx", None)
        if model_ctx is not None and len(model_ctx) >= offset + n:
            return np.asarray(model_ctx)[offset:offset + n]
        raise ValueError(
            f"adaptive ingest of {n} symbols at offset {offset} needs a ctx "
            f"map (model.ctx covers "
            f"{0 if model_ctx is None else len(model_ctx)})")

    def _check_flags(self, out, b: int, symbols) -> None:
        if not bool(out["zero_freq"][b]):
            return
        syms = np.unique(symbols.cpu().numpy() if torch.is_tensor(symbols)
                         else np.asarray(symbols, np.int64))
        f = np.asarray(self.model.f)
        bad = (syms[np.asarray(f[..., syms].min(axis=0) == 0).ravel()]
               if f.ndim == 2 else syms[f[syms] == 0])
        raise ValueError(
            "content uses symbols with zero quantized frequency in the "
            f"model (symbols {bad[:8].tolist()}) — it cannot be encoded; "
            "rebuild the model from counts covering these symbols")

    @staticmethod
    def _points(out, b: int):
        """Content b's found split slots as host arrays ``(q, k, y)``."""
        found = out["split_found"][b].cpu().numpy()
        idx = np.flatnonzero(found)
        q = out["split_q"][b].cpu().numpy()[idx]
        k = out["split_k"][b].cpu().numpy()[idx].astype(np.int64)
        y = out["split_y"][b].cpu().numpy()[idx].view(np.uint32)
        return q, k, y

    def _materialize(self, out, b: int, n_symbols: int,
                     symbols) -> IngestResult:
        self._check_flags(out, b, symbols)
        W = self.params.ways
        n_words = out["n_words"][b]
        q, k, y = self._points(out, b)
        points = tuple(SplitPoint(offset=int(qm), k=km, y=ym)
                       for qm, km, ym in zip(q, k, y))
        rplan = RecoilPlan(points=points, n_symbols=n_symbols,
                           n_words=n_words, ways=W)
        rplan.validate(self.params.lower_bound)
        # Words and permutation reside at the pow2 buckets (floor 1024) an
        # uploaded stream gets, so ingested and registered copies of
        # like-sized contents share decode plan keys.  The pipeline padded
        # its rows with zeros to at least those buckets, so the resident
        # copies are views of row b.
        bucket = pow2_bucket(n_words, 1024)
        words = out["stream"][b, :bucket]
        sym_bucket = pow2_bucket(n_symbols, 1024)
        by = out["by_symbol"][b, :sym_bucket]
        ds = DeviceStream(words=words, host=None, n_words=n_words,
                          bucket=bucket, by_symbol=by, sym_bucket=sym_bucket)
        return IngestResult(stream=ds, plan=rplan,
                            final_states=_host_u32(out["final_states"][b]),
                            n_words=n_words)
