"""Recoil split metadata: planning (encoder side), combining (server side),
and decoding (decoder side) — paper §3 and §4.

The object model:

  * :class:`SplitPoint` — one metadata entry: the stream offset ``p`` of the
    split's anchor word plus, per interleaved way, the reconstruction symbol
    index ``k[j]`` and the bounded intermediate state ``y[j] < L``.
  * :class:`RecoilPlan` — an ordered list of split points + stream geometry.
    ``M`` entries → ``M + 1`` decoder threads (the last thread initializes
    from the transmitted 32-bit final states that every variation carries).
  * ``plan_splits``    — encoder side: Def 4.1 heuristic + backward scans.
  * ``combine_plan``   — server side: decoder-adaptive scaling by *deleting*
    entries (paper §3.3); no re-encode, no bitstream touch.
  * ``build_split_states`` / ``decode_recoil`` — decoder side: derive each
    thread's walk bounds purely from the (possibly combined) metadata and run
    the single-pointer walk.

Thread m's kept output range is ``[c_{m-1}, c_m)`` with ``c_m = min_j k_m[j]``
(the paper's "synchronization completion point"); the final thread keeps
``[c_last, N)``.  Symbols in ``[c_m, a_m]`` (the Synchronization Section of
split m) are decoded twice: once as discarded side effects of thread m's
synchronization phase and once, kept, by thread m+1's cross-boundary phase.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import heuristic
from .interleaved import EncodedStream, SplitState, walk_decode_split
from .rans import StaticModel


@dataclasses.dataclass(frozen=True)
class SplitPoint:
    offset: int        # p — stream offset of the anchor word (first consumed)
    k: np.ndarray      # int64[W] — per-way reconstruction symbol index
    y: np.ndarray      # uint32[W] — per-way bounded state (< L, 16 bits)

    @property
    def anchor(self) -> int:
        return int(self.k.max())

    @property
    def completion(self) -> int:
        return int(self.k.min())

    def group_ids(self, ways: int) -> np.ndarray:
        return self.k // ways

    def validate(self, ways: int, lower_bound: int) -> None:
        if self.k.shape != (ways,) or self.y.shape != (ways,):
            raise ValueError("split point has wrong way count")
        if int(self.y.max(initial=0)) >= lower_bound:
            raise ValueError("intermediate state exceeds Lemma 3.1 bound")
        if np.any(self.k % ways != np.arange(ways)):
            raise ValueError("k[j] must be handled by way j (k % W == j)")


@dataclasses.dataclass(frozen=True)
class RecoilPlan:
    points: tuple[SplitPoint, ...]   # sorted by offset, strictly increasing
    n_symbols: int
    n_words: int
    ways: int

    @property
    def n_threads(self) -> int:
        return len(self.points) + 1

    def validate(self, lower_bound: int = 1 << 16) -> None:
        # One vectorized pass over the stacked metadata, not a Python loop
        # per point: validate runs on every registration AND on every
        # incremental extend, so at serving rates its cost is part of the
        # request path (it dominated the warm extend profile before).
        if not self.points:
            return
        W = self.ways
        if any(pt.k.shape != (W,) or pt.y.shape != (W,)
               for pt in self.points):
            raise ValueError("split point has wrong way count")
        ks = np.stack([pt.k for pt in self.points])
        ys = np.stack([pt.y for pt in self.points])
        offs = np.fromiter((pt.offset for pt in self.points), np.int64,
                           len(self.points))
        if int(ys.max()) >= lower_bound:
            raise ValueError("intermediate state exceeds Lemma 3.1 bound")
        if np.any(ks % W != np.arange(W)):
            raise ValueError("k[j] must be handled by way j (k % W == j)")
        if not (offs[0] > -1 and offs[-1] < self.n_words
                and np.all(offs[:-1] < offs[1:])):
            raise ValueError("split offsets must be strictly increasing")
        comps = ks.min(axis=1)
        if not (comps[0] > 0 and np.all(comps[:-1] < comps[1:])):
            raise ValueError("split completions must be strictly increasing")


def plan_splits(enc: EncodedStream, n_splits: int, *, window: int = 96) -> RecoilPlan:
    """Encoder side: pick split points with Def 4.1 and record metadata.

    ``n_splits`` is the number of decoder *threads* to support (paper's M);
    the plan then carries ``min(n_splits, feasible) - 1`` metadata entries.
    """
    W = enc.params.ways
    index = heuristic.EmissionIndex(enc.k_of_word, enc.y_of_word, W)
    offsets, ks, ys = heuristic.plan_split_offsets(
        index, enc.n_symbols, n_splits, window=window)
    points = [SplitPoint(offset=int(q), k=k, y=y)
              for q, k, y in zip(offsets, ks, ys)]
    plan = RecoilPlan(points=tuple(points), n_symbols=enc.n_symbols,
                      n_words=enc.n_words, ways=W)
    plan.validate(enc.params.lower_bound)
    return plan


def combine_plan(plan: RecoilPlan, n_threads: int) -> RecoilPlan:
    """Server side (paper §3.3): thin the metadata to ``n_threads`` threads by
    *deleting* entries — a pure metadata operation, O(M), no re-encode.

    Picks ~evenly spaced entries (the paper's "every other ceil(N/M)-th").
    """
    if n_threads >= plan.n_threads:
        return plan
    if n_threads < 1:
        raise ValueError("need at least one decoder thread")
    E = len(plan.points)
    want = n_threads - 1
    if want == 0:
        return dataclasses.replace(plan, points=())
    idx = np.unique(((np.arange(1, want + 1) * (E + 1)) // (want + 1)) - 1)
    idx = idx[(idx >= 0) & (idx < E)]
    return dataclasses.replace(plan, points=tuple(plan.points[int(i)] for i in idx))


def build_split_states(plan: RecoilPlan, final_states: np.ndarray) -> list[SplitState]:
    """Decoder side: derive every thread's walk purely from metadata."""
    W = plan.ways
    N = plan.n_symbols
    states: list[SplitState] = []
    c_prev = 0
    for pt in plan.points:
        states.append(SplitState(
            k=pt.k, y=pt.y, x0=np.zeros(W, dtype=np.uint32),
            q0=pt.offset, start=pt.anchor, stop=c_prev,
            keep_lo=c_prev, keep_hi=pt.completion))
        c_prev = pt.completion
    sentinel = np.arange(N + W, N + 2 * W, dtype=np.int64)  # k%W == j, never hit
    sentinel = sentinel - (sentinel % W) + np.arange(W)
    states.append(SplitState(
        k=sentinel, y=np.zeros(W, dtype=np.uint32),
        x0=np.asarray(final_states, dtype=np.uint32),
        q0=plan.n_words - 1, start=N - 1, stop=c_prev,
        keep_lo=c_prev, keep_hi=N))
    return states


def decode_recoil(plan: RecoilPlan, stream: np.ndarray, final_states: np.ndarray,
                  model: StaticModel) -> np.ndarray:
    """Oracle parallel-semantics decode: independent walks, one per thread.

    Threads are run sequentially here (host oracle); each walk touches only
    its own state and a disjoint kept range, so the order is irrelevant —
    the vectorized/CUDA paths run them genuinely in parallel.
    """
    out = np.full(plan.n_symbols, -1, dtype=np.int64)
    consumed = 0
    for split in build_split_states(plan, final_states):
        consumed += walk_decode_split(split, stream, model, out)
    # NOTE: consumed > n_words is expected — every split's Synchronization
    # Section is decoded twice (discarded side effects by thread m, kept
    # cross-boundary outputs by thread m+1), so its words are read twice.
    if consumed < plan.n_words:
        raise ValueError(
            f"walks consumed {consumed} words < stream length {plan.n_words}")
    assert (out >= 0).all(), "kept ranges did not cover all symbols"
    return out


def metadata_cost_bytes(plan: RecoilPlan) -> dict:
    """Uncoded metadata footprint (for napkin math; the §4.3 coded size is
    what benchmarks report, via :mod:`repro_torch.core.metadata`)."""
    E = len(plan.points)
    return {
        "entries": E,
        "states_bytes": E * plan.ways * 2,          # 16-bit bounded states
        "raw_entry_bytes": E * (plan.ways * 2 + 8),  # + offset/anchor raw
    }
