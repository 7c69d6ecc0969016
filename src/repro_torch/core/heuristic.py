"""Split-point selection heuristic (paper Definition 4.1).

Given the emission log of an interleaved stream, choose M-1 split points
(each at a renormalization emission) minimizing, greedily per split,

    H(t, t_s) = |t - T| + |t - t_s - T|,   T = ceil(N / M)

where t is the number of symbols the thread walks (its sub-bitstream interval
including the Synchronization Section) and t_s the Synchronization Section
size.  A candidate emission offset ``q`` has anchor ``a = k_of_word[q]`` and
sync completion ``c = min_j (last emission of way j at offset <= q)``; then
for previous kept boundary ``c_prev``:

    t   = a - c_prev + 1
    t_s = a - c + 1        =>  t - t_s = c - c_prev  (the kept symbol count).

Candidates are only valid if the backward scan completes (every way emitted at
least once at or below ``q``) and ``c > c_prev`` (non-empty keep range).

The backward scan is evaluated *vectorized over candidate windows*: per-way
emission offsets are monotone, so "last emission of way j at offset <= q" is
one ``searchsorted`` per way — O(W log) per candidate instead of a serial
word walk, keeping planning cheap even at 2176 splits on 10 MB streams.
"""

from __future__ import annotations

import numpy as np


class EmissionIndex:
    """Per-way view of the emission log enabling vectorized backward scans."""

    def __init__(self, k_of_word: np.ndarray, y_of_word: np.ndarray, ways: int):
        self.k_of_word = np.asarray(k_of_word, dtype=np.int64)
        self.y_of_word = np.asarray(y_of_word, dtype=np.uint32)
        self.ways = ways
        way = (self.k_of_word % ways).astype(np.int64)
        self.way_offsets = [np.flatnonzero(way == j) for j in range(ways)]

    def scan(self, qs: np.ndarray):
        """Vectorized paper-§4.1 backward scan for candidate offsets ``qs``.

        Returns (k[Q, W], y[Q, W], valid[Q]): way j's last emission symbol
        index / bounded state at offset <= q, and whether all ways were found.
        """
        qs = np.asarray(qs, dtype=np.int64)
        Q = len(qs)
        k = np.full((Q, self.ways), -1, dtype=np.int64)
        y = np.zeros((Q, self.ways), dtype=np.uint32)
        valid = np.ones(Q, dtype=bool)
        for j, offs in enumerate(self.way_offsets):
            idx = np.searchsorted(offs, qs, side="right") - 1
            ok = idx >= 0
            sel = offs[np.clip(idx, 0, None)]
            k[:, j] = np.where(ok, self.k_of_word[sel], -1)
            y[:, j] = np.where(ok, self.y_of_word[sel], 0)
            valid &= ok
        return k, y, valid


def backward_scan(k_of_word: np.ndarray, q: int, ways: int):
    """Scalar backward scan (kept for tests/teaching; see EmissionIndex)."""
    k = np.full(ways, -1, dtype=np.int64)
    remaining = ways
    qq = q
    while qq >= 0 and remaining > 0:
        j = int(k_of_word[qq]) % ways
        if k[j] < 0:
            k[j] = int(k_of_word[qq])
            remaining -= 1
        qq -= 1
    return k, remaining == 0


def plan_split_offsets(index: EmissionIndex, n_symbols: int, n_splits: int,
                       *, window: int = 96):
    """Choose up to ``n_splits - 1`` emission offsets greedily minimizing H.

    Returns (offsets, k[E, W], y[E, W]) with strictly increasing offsets; may
    return fewer than requested on tiny streams (fewer decoder threads).
    """
    n_words = int(len(index.k_of_word))
    W = index.ways
    empty = (np.zeros(0, np.int64), np.zeros((0, W), np.int64),
             np.zeros((0, W), np.uint32))
    if n_splits <= 1 or n_words == 0 or n_symbols <= 0:
        return empty
    chosen, all_k, all_y = [], [], []
    c_prev = 0
    min_q = 0
    for m in range(n_splits - 1):
        # Def 4.1's T = ceil(N/M), recomputed on the *remaining* interval so
        # the sync-section bias (kept ~ T - t_s/2 per split) cannot
        # accumulate into a giant final-thread residue.
        T = -(-(n_symbols - c_prev) // (n_splits - m))
        target_symbol = c_prev + T
        if target_symbol >= n_symbols:
            break
        center = int(np.searchsorted(index.k_of_word, target_symbol))
        lo, hi = max(min_q, center - window), min(n_words - 1, center + window)
        found = False
        for _ in range(8):
            if hi < lo:
                break
            qs = np.arange(lo, hi + 1, dtype=np.int64)
            k, y, valid = index.scan(qs)
            c = k.min(axis=1)
            a = k.max(axis=1)
            mask = valid & (c > c_prev)
            if mask.any():
                t = a - c_prev + 1
                kept = c - c_prev
                h = np.abs(t - T) + np.abs(kept - T)
                h = np.where(mask, h, np.iinfo(np.int64).max)
                best = int(np.argmin(h))
                chosen.append(int(qs[best]))
                all_k.append(k[best])
                all_y.append(y[best])
                c_prev = int(c[best])
                min_q = int(qs[best]) + 1
                found = True
                break
            lo, hi = max(min_q, lo - 2 * window), min(n_words - 1, hi + 2 * window)
        if not found:
            break
    if not chosen:
        return empty
    return (np.asarray(chosen, np.int64), np.stack(all_k), np.stack(all_y))
