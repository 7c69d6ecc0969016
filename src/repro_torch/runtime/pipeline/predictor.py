"""Predictive hot-set serving: popularity heat + speculative pre-thinning.

Everything the capability registry and service memos do *reactively* — thin
the split metadata, pack the downscaled container, derive the
symbol-layout permutation slice, resolve the fused dispatch shape's
launcher — this module does *ahead of the first request*, for the
(content, capability) pairs traffic says are hot (the JAX package's
DESIGN.md §12).
The per-capability bitstream-organization cost model of Said et al.
(PAPERS: 2312.00921) argues exactly this amortization: the thinning work
belongs off the request path.

Two pieces, both pure bookkeeping plus calls into existing service
surfaces:

  * :class:`HeatTracker` — a popularity-decayed score per
    (content, capability) pair, fed by ``broker.submit`` traffic (one
    ``DecayingCounter`` per pair, half-life semantics: heat tracks the
    recent request rate and fades when a pair goes quiet).  Operators can
    also *declare* expected popularity via ``broker.anticipate`` — same
    counter, synthetic weight.
  * :class:`SpeculativePrethinner` — turns the tracker's hot set into a
    queue of idempotent work units, executed one per broker idle gap
    (riding the ingest worker, never blocking decode dispatch):

      - ``prethin`` units: registry plan + container memos and the
        service's single-request :class:`DecodePlan` (thinned batch +
        permutation slice staged) for one hot pair, tagged with the
        content generation so a re-registration re-derives in the next
        gap;
      - ``warm`` units: the fused dispatch shapes the hot set implies
        under the controller's quantized group sizes, probed via
        ``DecodeService.prepare_group`` + ``session.is_compiled`` so only
        the shapes whose launcher is MISSING run — shapes warm traffic
        already resolved cost a dict lookup.

"Compiled" keeps the reference's word with the port's meaning: the plan
key's launcher was resolved by the decoder session
(``DecoderSession.is_compiled``; the kernels take their sizes at run time,
so no compiler runs).  A warm unit launches the group once and waits on
the readiness event recorded right after that launch (on the CPU the
launch has run to its end).

The covered set is bounded (``capacity``): when full, the coldest covered
pair is evicted from the registry memos and the service plan memo, and
re-derives bit-exactly if it re-heats — the predictive layer is a cache
in front of derivation, never the source of truth.
"""

from __future__ import annotations

import threading
import time

from ..metrics import DecayingCounter
from ..observability import NULL_TRACE
from ..serve import _launched


class HeatTracker:
    """Popularity-decayed heat per (content name, capability) pair.

    ``observe(name, n_threads)`` on every broker submit; ``hot_set`` ranks
    pairs by decayed heat.  The clock is injectable for synthetic-decay
    tests.  Thread-safe: submits arrive from caller threads while the
    ingest worker reads the hot set.
    """

    def __init__(self, half_life_s: float = 30.0, clock=time.perf_counter):
        self.half_life_s = float(half_life_s)
        self._clock = clock
        self._pairs: dict[tuple, DecayingCounter] = {}
        self._lock = threading.Lock()
        self.observations = 0

    def observe(self, name: str, n_threads: int, weight: float = 1.0,
                now: float | None = None) -> float:
        now = self._clock() if now is None else now
        key = (name, int(n_threads))
        with self._lock:
            ctr = self._pairs.get(key)
            if ctr is None:
                ctr = self._pairs[key] = DecayingCounter(self.half_life_s)
            self.observations += 1
            return ctr.observe(weight, now)

    def heat(self, name: str, n_threads: int,
             now: float | None = None) -> float:
        now = self._clock() if now is None else now
        with self._lock:
            ctr = self._pairs.get((name, int(n_threads)))
            return 0.0 if ctr is None else ctr.value(now)

    def hot_set(self, limit: int | None = None, min_heat: float = 0.0,
                now: float | None = None) -> list[tuple]:
        """(name, n_threads) pairs with decayed heat >= ``min_heat``,
        hottest first, at most ``limit`` of them."""
        now = self._clock() if now is None else now
        with self._lock:
            scored = [(ctr.value(now), key)
                      for key, ctr in self._pairs.items()]
        scored = [(h, key) for h, key in scored if h >= min_heat]
        scored.sort(key=lambda t: (-t[0], t[1]))
        if limit is not None:
            scored = scored[:limit]
        return [key for _, key in scored]

    def forget(self, name: str) -> None:
        """Drop every pair of a content (e.g. after unregistration)."""
        with self._lock:
            for key in [k for k in self._pairs if k[0] == name]:
                del self._pairs[key]

    def snapshot(self, top: int = 8) -> dict:
        now = self._clock()
        with self._lock:
            scored = sorted(
                ((ctr.value(now), key) for key, ctr in self._pairs.items()),
                key=lambda t: (-t[0], t[1]))
            return {
                "pairs": len(self._pairs),
                "observations": self.observations,
                "half_life_s": self.half_life_s,
                "top": [{"name": k[0], "n_threads": k[1],
                         "heat": round(h, 3)} for h, k in scored[:top]],
            }


class SpeculativePrethinner:
    """Hot-set -> idempotent speculative work units, one per idle gap.

    ``step()`` (called by the broker's ingest worker whenever its queue is
    empty) claims and runs at most ONE unit — a prethin derivation or a
    warm probe/launch — so ingest work arriving mid-gap waits at most one
    unit.  ``speculate()`` drives the queue to empty synchronously (used
    by benchmarks and tests for determinism, and by operators who want a
    blocking pre-warm after ``anticipate``).  A non-blocking mutex keeps
    the two entry points from duplicating work.

    Work derivation order: every hot pair's prethin first (cheap host-side
    metadata, unblocks early partial flushes), then the warm shapes — per
    hot lane, the controller's quantized sizes x pow2 distinct-content
    mixes, mirroring ``broker.warm``'s enumeration so the launcher keys
    coincide with what dispatch actually requests.
    """

    def __init__(self, svc, registry, controller, tracker, *,
                 top_k: int = 16, min_heat: float = 0.25,
                 capacity: int | None = None,
                 warm_distincts: tuple = (1, 2, 4, 8)):
        self._svc = svc
        self._registry = registry
        self._controller = controller
        self.tracker = tracker
        self.top_k = int(top_k)
        self.min_heat = float(min_heat)
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._warm_distincts = tuple(sorted(set(warm_distincts)))
        self._run_lock = threading.Lock()
        # (name, n_threads) -> content generation the pair was prethinned
        # at; a registration bump makes the pair due again.
        self._covered: dict[tuple, int] = {}
        # (n_threads, size, distinct, names) warm keys already probed.
        self._warmed: set = set()
        self.prethins = 0
        self.warm_probes = 0
        self.warm_compiles = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    # Work derivation
    # ------------------------------------------------------------------

    def hot_pairs(self) -> list[tuple]:
        return self.tracker.hot_set(limit=self.top_k, min_heat=self.min_heat)

    def _next_task(self):
        """The next due unit, or None when the hot set is fully covered.
        Caller holds ``_run_lock``.  Under a ``capacity`` bound only the
        top-``capacity`` hot pairs are coverage candidates — deriving a
        pair the eviction policy would immediately throw back out (it is
        colder than every resident) would churn derivation forever."""
        hot = self.hot_pairs()
        candidates = hot if self.capacity is None else hot[:self.capacity]
        for name, cap in candidates:
            gen = self._svc.generation(name)
            if gen == 0:
                continue   # anticipated but not yet ingested
            if self._covered.get((name, cap)) != gen:
                return ("prethin", name, cap, gen)
        lanes: dict[int, list] = {}
        for name, cap in hot:
            if self._svc.generation(name) == 0:
                continue
            lanes.setdefault(cap, []).append(name)
        for cap in sorted(lanes):
            names = sorted(lanes[cap])
            for size in self._controller.cfg.sizes():
                # d=1 enumerates EVERY hot name's uniform group, not just
                # the lane's first: a partial flush pads a lane's requests
                # with repeats of themselves, so each pair's uniform shape
                # at each quantized size is the cold-first-request shape.
                for name in names:
                    key = (cap, size, 1, (name,))
                    if key not in self._warmed:
                        return ("warm", *key)
                distincts = sorted({
                    min(d, len(names), size)
                    for d in (*self._warm_distincts, size)} - {1})
                for d in distincts:
                    key = (cap, size, d, tuple(names[:d]))
                    if key not in self._warmed:
                        return ("warm", *key)
        return None

    def pending(self) -> bool:
        """Whether a speculative unit is currently due (non-claiming)."""
        with self._run_lock:
            return self._next_task() is not None

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """Run at most one due unit; False when idle (nothing due) or when
        another runner holds the mutex (the caller just waits its normal
        idle timeout)."""
        if not self._run_lock.acquire(blocking=False):
            return False
        try:
            task = self._next_task()
            if task is None:
                return False
            self._run(task)
            return True
        finally:
            self._run_lock.release()

    def speculate(self) -> int:
        """Drive speculation to empty; returns units run.  Blocking —
        resolves every missing hot-set shape's launcher before returning."""
        with self._run_lock:
            n = 0
            while (task := self._next_task()) is not None:
                self._run(task)
                n += 1
            return n

    def _run(self, task) -> None:
        # Speculative work is traced like any other path (kind
        # "speculate"): idle-gap units show up in the ring next to the
        # requests they pre-warm, so "where did the gap go" is answerable.
        obs = getattr(self._svc, "obs", None)
        tr = (NULL_TRACE if obs is None else
              obs.tracer.start("speculate", name=str(task[1]),
                               unit=task[0]))
        try:
            self._run_unit(task)
        finally:
            tr.phase("run")
            tr.finish("ok")

    def _run_unit(self, task) -> None:
        if task[0] == "prethin":
            _, name, cap, gen = task
            try:
                self._registry.prethin(name, cap)
                self._svc.prepare_request(name, cap)
            except KeyError:
                return   # unregistered between derivation and run
            self._covered[(name, cap)] = gen
            self.prethins += 1
            self._enforce_capacity()
            return
        _, cap, size, d, names = task
        key = (cap, size, d, names)
        reqs = [(names[i % d], cap) for i in range(size)]
        try:
            plan = self._svc.prepare_group(reqs)
        except KeyError:
            self._warmed.add(key)
            return
        self.warm_probes += 1
        if not self._svc.session.is_compiled(plan):
            ready = _launched(self._svc.session.execute(plan))
            if ready is not None:
                ready.synchronize()
            self.warm_compiles += 1
        self._warmed.add(key)

    def _enforce_capacity(self) -> None:
        if self.capacity is None:
            return
        while len(self._covered) > self.capacity:
            victim = min(self._covered,
                         key=lambda k: (self.tracker.heat(k[0], k[1]), k))
            del self._covered[victim]
            self._registry.evict(*victim)
            self._svc.evict_prepared(*victim)
            self.evictions += 1

    def snapshot(self) -> dict:
        with self._run_lock:
            return {
                "covered_pairs": len(self._covered),
                "warmed_shapes": len(self._warmed),
                "prethins": self.prethins,
                "warm_probes": self.warm_probes,
                "warm_compiles": self.warm_compiles,
                "evictions": self.evictions,
                "capacity": self.capacity,
                "top_k": self.top_k,
                "min_heat": self.min_heat,
            }
