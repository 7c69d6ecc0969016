"""Capability registry: per-client parallelism, declared once, served always.

The paper's decoder-adaptive scalability (§3.3, §4.3) sizes metadata for the
fastest decoder and *downscales* per client by deleting split entries.  The
synchronous service API makes the client restate its ``n_threads`` on every
call; the registry moves that to a per-client declaration:

  * ``declare(client_id, n_threads)`` — records the client's parallel
    capacity (a phone declares 2, a GPU box 2176);
  * ``plan_for(name, client_id)`` — the content's split metadata thinned to
    the client (``core.recoil.combine_plan`` — pure entry deletion),
    memoized per ``(content generation, n_threads)`` so a thousand phones
    share one thinning;
  * ``container_for(name, client_id)`` — the full on-wire payload
    (``core.container.pack_recoil``): bitstream + right-sized §4.3 metadata
    blob, also generation-memoized.  This is what the content-delivery
    example ships — transfer size shrinks monotonically with declared
    parallelism while the bitstream bytes stay identical;
  * ``submit_for(name, client_id)`` — route a decode through the service
    (broker lanes when the pipeline is running) at the client's capability.

Invalidation is by content *generation* (``DecodeService.generation`` bumps
on every re-registration), so the registry never serves a stale thinning
after an ingest refresh and needs no callback channel from the service.
Generation and content bytes are read in ONE service-lock hold
(``DecodeService.content_snapshot``) — the earlier two-step read could
interleave with a concurrent ``extend()`` and tag a memo entry with a
generation that does not match its bytes (regression-tested under a
threaded extend storm in ``tests/test_predictive.py``).

Two predictive-serving surfaces ride on top (DESIGN.md §12):

  * ``prethin(name, n_threads)`` — derive both memo entries for a
    (content, capability) pair *speculatively*, off the request path.
    Entries derived this way are flagged; the first real request that
    lands on one counts a ``speculative_hit`` (the hit-rate the CI guard
    watches).
  * an optional ``max_entries`` budget with popularity-ranked eviction:
    when a heat tracker is attached, the coldest (name, n_threads) pair is
    evicted first; without one, insertion order stands in.  Evicted pairs
    re-derive bit-exactly on their next touch — the memos are a cache, not
    the source of truth.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from ...core import container
from ...core.interleaved import EncodedStream
from ...core.recoil import RecoilPlan, combine_plan


@dataclasses.dataclass(frozen=True)
class ClientCapability:
    client_id: str
    n_threads: int


class CapabilityRegistry:
    """Client capability declarations + generation-memoized downscaling."""

    def __init__(self, svc, *, max_entries: int | None = None, tracker=None):
        self._svc = svc
        self._clients: dict[str, ClientCapability] = {}
        # (name, n_threads) -> (generation, value, speculative_flag).
        # The generation is stored IN the value, not the key, so a content
        # refresh overwrites the entry instead of leaking one plan + one
        # full wire payload per (generation, capability) forever — the
        # memos are bounded by #contents x #distinct capabilities, and
        # optionally by ``max_entries`` (heat-ranked eviction, see header).
        self._plan_memo: dict[tuple, tuple] = {}
        self._container_memo: dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._tracker = tracker   # HeatTracker (predictor.py) or None
        self.memo_hits = 0
        self.memo_misses = 0
        self.speculative_hits = 0
        self.prethins = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    # Declarations
    # ------------------------------------------------------------------

    def declare(self, client_id: str, n_threads: int) -> ClientCapability:
        if n_threads < 1:
            raise ValueError(
                f"client {client_id!r} declared {n_threads} threads; "
                "need at least one")
        cap = ClientCapability(client_id=str(client_id),
                               n_threads=int(n_threads))
        with self._lock:
            self._clients[cap.client_id] = cap
        return cap

    def n_threads(self, client_id: str) -> int:
        with self._lock:
            cap = self._clients.get(client_id)
        if cap is None:
            raise KeyError(
                f"client {client_id!r} never declared a capability")
        return cap.n_threads

    @property
    def clients(self) -> dict:
        with self._lock:
            return dict(self._clients)

    def attach_tracker(self, tracker) -> None:
        """Wire in the broker's heat tracker so budget eviction ranks by
        popularity instead of insertion order."""
        with self._lock:
            self._tracker = tracker

    # ------------------------------------------------------------------
    # Downscaled serving
    # ------------------------------------------------------------------

    def _lookup(self, memo: dict, key: tuple, gen: int):
        """Under ``_lock``: the memoized value iff it matches the content's
        CURRENT generation (a stale entry is a miss and gets overwritten).
        A hit on a speculatively-derived entry counts ``speculative_hits``
        — the pre-thinner did this request's derivation off the request
        path."""
        with self._lock:
            hit = memo.get(key)
            if hit is not None and hit[0] == gen:
                self.memo_hits += 1
                if hit[2]:
                    self.speculative_hits += 1
                return hit[1]
            self.memo_misses += 1
            return None

    def _store(self, memo: dict, key: tuple, gen: int, value,
               speculative: bool) -> None:
        with self._lock:
            memo[key] = (gen, value, speculative)
            if self.max_entries is None:
                return
            while len(memo) > self.max_entries:
                victim = self._coldest(memo)
                del memo[victim]
                self.evictions += 1

    def _coldest(self, memo: dict):
        """Eviction victim under the entry budget: the lowest-heat
        (name, n_threads) pair when a tracker is attached (popularity decay
        evicts cold pairs first), else the oldest-inserted.  The
        just-inserted key IS a candidate — a cold pair's derivation is
        returned to its caller but does not displace a hotter resident."""
        if self._tracker is None:
            return next(iter(memo))
        return min(memo, key=lambda k: (self._tracker.heat(k[0], k[1]), k))

    def _plan(self, name: str, n_threads: int,
              speculative: bool = False) -> RecoilPlan:
        key = (name, int(n_threads))
        gen, c = self._svc.content_snapshot(name)
        hit = self._lookup(self._plan_memo, key, gen)
        if hit is not None:
            return hit
        plan = combine_plan(c.plan, key[1])
        self._store(self._plan_memo, key, gen, plan, speculative)
        return plan

    def _container(self, name: str, n_threads: int,
                   speculative: bool = False) -> bytes:
        key = (name, int(n_threads))
        gen, c = self._svc.content_snapshot(name)
        hit = self._lookup(self._container_memo, key, gen)
        if hit is not None:
            return hit
        plan = combine_plan(c.plan, key[1])
        ds = c.stream
        words = (ds.host if ds.host is not None
                 else ds.words[:ds.n_words].cpu().numpy())
        # pack_recoil consumes only the stream/finals/geometry fields; the
        # emission log is an encoder-side artifact the wire format never
        # carries, so zeros stand in for it here.
        enc = EncodedStream(
            stream=np.ascontiguousarray(words).astype(np.uint16),
            final_states=c.final_states,
            n_symbols=plan.n_symbols,
            params=self._svc.session.model.params,
            k_of_word=np.zeros(ds.n_words, np.int64),
            y_of_word=np.zeros(ds.n_words, np.uint32))
        buf = container.pack_recoil(enc, self._svc.session.model, plan)
        self._store(self._container_memo, key, gen, buf, speculative)
        return buf

    def plan_for(self, name: str, client_id: str) -> RecoilPlan:
        """The content's split metadata thinned to the client's declared
        parallelism (paper §3.3: pure entry deletion, no bitstream touch)."""
        return self._plan(name, self.n_threads(client_id))

    def container_for(self, name: str, client_id: str) -> bytes:
        """The client-sized on-wire payload: identical bitstream bytes,
        §4.3 metadata thinned to the declared capability."""
        return self._container(name, self.n_threads(client_id))

    def plan_for_threads(self, name: str, n_threads: int) -> RecoilPlan:
        """Capability-keyed variant of :meth:`plan_for` (no client
        declaration needed — the broker's lanes and the pre-thinner work in
        capabilities, not client ids)."""
        return self._plan(name, n_threads)

    def container_for_threads(self, name: str, n_threads: int) -> bytes:
        """Capability-keyed variant of :meth:`container_for`."""
        return self._container(name, n_threads)

    def prethin(self, name: str, n_threads: int) -> None:
        """Speculatively derive the thinned plan AND the on-wire container
        for one (content, capability) pair (DESIGN.md §12).  Runs in the
        broker's idle gaps; entries land flagged so the first real request
        that hits one is counted in ``speculative_hits``.  Already-current
        entries are left alone (idempotent)."""
        self.prethins += 1
        self._plan(name, n_threads, speculative=True)
        self._container(name, n_threads, speculative=True)

    def evict(self, name: str, n_threads: int) -> bool:
        """Drop both memo entries for one pair (predictive-cache eviction);
        returns whether anything was dropped.  The pair re-derives
        bit-exactly on its next touch."""
        key = (name, int(n_threads))
        with self._lock:
            dropped = self._plan_memo.pop(key, None) is not None
            if self._container_memo.pop(key, None) is not None:
                dropped = True
            if dropped:
                self.evictions += 1
        return dropped

    def layout_for(self, name: str) -> str:
        """The decode layout the content serves under — negotiated like a
        capability, but server-side: content registered/ingested with an
        emission log serves the pointer-free symbol-indexed walk, anything
        else the pointer fallback (DESIGN.md §9).  Downscaling is layout
        -independent: a thinned plan deletes split entries only, and the
        permutation is indexed by absolute symbol position, so the same
        ``words_by_symbol`` serves every declared ``n_threads``."""
        return self._svc.layout_for(name)

    def submit_for(self, name: str, client_id: str, deadline=None):
        """Decode ticket at the client's declared capability (broker lanes
        when the pipeline is running, sync microbatching otherwise).
        ``deadline`` is a deadline class name or explicit ms budget
        (controller.py)."""
        return self._svc.submit(name, self.n_threads(client_id),
                                deadline=deadline)

    def decode_for(self, name: str, client_id: str):
        """Immediate decode at the client's declared capability."""
        return self._svc.decode(name, self.n_threads(client_id))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "clients": {c.client_id: c.n_threads
                            for c in self._clients.values()},
                "memo_hits": self.memo_hits,
                "memo_misses": self.memo_misses,
                "speculative_hits": self.speculative_hits,
                "prethins": self.prethins,
                "evictions": self.evictions,
                "max_entries": self.max_entries,
                "plans_cached": len(self._plan_memo),
                "containers_cached": len(self._container_memo),
            }
