"""DecodePlan IR: a decode request, prepared once into executor-ready form.

    WalkBatch + DeviceStream + n_symbols
        --executor.plan()-->  DecodePlan          (host work, per request)
        --session cache[plan.key]-->  launcher    (resolved only on miss)
        --executor.run(fn, plan)-->  device syms  (no host round-trip)

A :class:`DecodePlan` captures everything the launch needs:

  * ``key``      — the plan-cache key.  Two plans with equal keys run the
                   same launcher at the same bucketed shapes (all bucketed
                   dims equal, same backend/LUT/layout config);
  * ``args``     — the positional argument tuple, already padded to the
                   bucketed shapes and placed on the session's device;
  * ``statics``  — the launch's scalar arguments (``n_steps``, ``n_symbols``
                   etc. at their *bucketed* values);
  * ``n_symbols``— the real output length; the bucket tail is sliced off
                   after the call.

Bucketing policy: memory-dominant dims pad to powers of two
(:func:`pow2_bucket`), compute-dominant dims to powers of two and their
1.5x midpoints (:func:`work_bucket`).  Padding is inert by construction —
extra splits carry ``start = -1`` (never active), extra steps walk groups
below every ``stop``, extra stream words are never indexed, extra output
slots are sliced off.

:func:`concat_walk_batches` is the microbatch fusion primitive: N requests'
WalkBatches become one batch whose per-request rows write disjoint output
windows (``out_base`` shifted by each request's symbol offset) and read
disjoint stream windows (``q0`` shifted by each stream's word offset in a
fused stream, when requests target different contents).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..vectorized import WalkBatch


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) — memory-dominant dims."""
    n = max(int(n), floor, 1)
    return 1 << (n - 1).bit_length()


def work_bucket(n: int, floor: int = 1) -> int:
    """Smallest of {2^k, 1.5 * 2^k} >= max(n, floor) — compute-dominant dims
    (walk steps, split rows), where pure powers of two could pad the walk
    by up to 2x; the 1.5x midpoints cap the waste at ~1.5x for one extra
    plan shape per octave."""
    n = max(int(n), floor, 1)
    p = 1 << max(0, (n - 1).bit_length() - 1)
    if n <= p:
        return p
    if n <= p + p // 2:
        return p + p // 2
    return 2 * p


class BucketPolicy:
    """Pluggable bucket ladder for plan-cache shape quantization.

    An executor asks its policy for two kinds of buckets: ``work(n)`` for
    compute-dominant dims (walk steps, split rows — padding is walked) and
    ``mem(n)`` for memory-dominant dims (output slots — padding is stored,
    barely touched).  Contract relied on by every executor:

      * **coverage** — ``work(n, floor) >= max(n, floor, 1)`` (same for
        ``mem``): padding never truncates;
      * **monotone** — ``n1 <= n2`` implies ``bucket(n1) <= bucket(n2)``;
      * **idempotent** — ``bucket(bucket(n)) == bucket(n)``;
      * **pure** — the result depends only on ``(n, floor)``.

    ``tag`` joins every plan key, so two policies that happen to agree on
    some bucket values never alias one session's plans.
    """

    tag: str = "?"

    def work(self, n: int, floor: int = 1) -> int:
        raise NotImplementedError

    def mem(self, n: int, floor: int = 1) -> int:
        raise NotImplementedError


class LegacyBucketPolicy(BucketPolicy):
    """The hand-picked ladder: pow2 memory dims, pow2 + 1.5x-midpoint work
    dims.  The default wherever no policy is supplied."""

    tag = "legacy"

    def work(self, n: int, floor: int = 1) -> int:
        return work_bucket(n, floor)

    def mem(self, n: int, floor: int = 1) -> int:
        return pow2_bucket(n, floor)


#: Shared default: module-level so "no policy" means ONE policy object (and
#: one tag) everywhere, not per-session lookalikes.
LEGACY_POLICY = LegacyBucketPolicy()


@dataclasses.dataclass(frozen=True)
class DeviceStream:
    """A stream registered with a session, resident on its device.

    ``words`` holds the 16-bit stream words as int32, zero-padded to the
    pow2 ``bucket``; ``host`` keeps the original words (``None`` for fused
    streams built by the microbatcher).

    ``by_symbol`` is the symbol-indexed permutation of the same words:
    entry ``i`` is the word emitted at flat symbol index ``i`` (0 where
    symbol ``i`` emitted nothing), padded to ``sym_bucket``, as int16 (u16
    bit patterns, streams under 2^16 words) or int32.  It exists only for
    content whose emission log was available at registration; ``None`` keeps
    the handle on the pointer walk.  The wire format never carries it.
    """

    words: torch.Tensor           # int32[bucket], zero-padded tail
    host: np.ndarray | None       # uint16/uint32[n_words] — original words
    n_words: int
    bucket: int
    by_symbol: torch.Tensor | None = None   # int16/int32[sym_bucket]
    sym_bucket: int = 0


def perm_dtype_name(t: torch.Tensor) -> str:
    """The unsigned width a permutation tensor's bit patterns stand for."""
    return {torch.int16: "u16", torch.int32: "u32"}[t.dtype]


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """A prepared decode request (see module docstring).

    ``key`` is hashable; ``args``/``statics`` are consumed positionally by
    the executor that built the plan — plans are not portable across
    executors (the key's leading impl tag enforces that in the cache).
    """

    key: tuple
    args: tuple
    statics: dict
    n_symbols: int
    out_bucket: int
    layout: str = "pointer"   # "pointer" or "symbol"; joins the key


SPLIT_FIELDS = ("k", "y", "x0", "q0", "g_hi", "start", "stop",
                "keep_lo", "keep_hi", "out_base")

# The symbol-indexed walk drops ``q0`` from the argument list (there is no
# stream pointer) and gains the per-row permutation base.  Field order
# matches ``vectorized._walk_batch_symbol_impl``.
SYMBOL_SPLIT_FIELDS = ("k", "y", "x0", "sym_base", "g_hi", "start", "stop",
                       "keep_lo", "keep_hi", "out_base")

# Inert padding rows: start = -1 never activates, k = 2^30 never reconstructs.
_PAD_FILL = {"k": 2 ** 30, "start": -1}


def pad_split_arrays(batch: WalkBatch, s_bucket: int,
                     device) -> dict[str, torch.Tensor]:
    """Pad the SoA split arrays to the split-count bucket with inert rows;
    returns int32 tensors on ``device`` (u32 fields as bit patterns)."""
    S = batch.k.shape[0]
    pad = s_bucket - S
    out = {}
    for name in ("k", "y", "x0", "q0", "g_hi", "start", "stop", "keep_lo",
                 "keep_hi", "out_base", "sym_base"):
        a = batch.sym_bases() if name == "sym_base" else getattr(batch, name)
        a = np.ascontiguousarray(a)
        a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
        if pad:
            ext = np.full((pad,) + a.shape[1:], _PAD_FILL.get(name, 0),
                          np.int32)
            a = np.concatenate([a, ext])
        out[name] = torch.as_tensor(a, device=device)
    return out


def concat_walk_batches(batches: Sequence[WalkBatch],
                        sym_offsets: Sequence[int],
                        word_offsets: Sequence[int] | None = None,
                        perm_offsets: Sequence[int] | None = None) -> WalkBatch:
    """Fuse N WalkBatches into one (microbatch coalescing).

    Request i's rows write output window ``[sym_offsets[i], ...)`` (its
    ``out_base`` shifts by the offset) and, when ``word_offsets`` is given,
    read stream window starting at ``word_offsets[i]`` of a fused stream
    (its ``q0`` shifts).  ``perm_offsets`` is the symbol-layout analogue:
    request i's rows gather from window ``perm_offsets[i]`` of a fused
    ``words_by_symbol`` permutation (its ``sym_base`` shifts; offsets must
    be multiples of ``ways`` — they are sym-bucket-aligned in practice).
    Rows stay per-request-inert exactly as before; the fused walk runs
    max(n_steps) steps for every row.
    """
    ways = {b.ways for b in batches}
    if len(ways) != 1:
        raise ValueError(f"cannot fuse batches with mixed ways {sorted(ways)}")
    W = ways.pop()
    if word_offsets is None:
        word_offsets = [0] * len(batches)
    if perm_offsets is None:
        perm_offsets = [0] * len(batches)

    def cat(field: str) -> np.ndarray:
        return np.concatenate([getattr(b, field) for b in batches])

    out_base = np.concatenate(
        [b.out_base.astype(np.int64) + int(o)
         for b, o in zip(batches, sym_offsets)])
    keep_hi = cat("keep_hi")
    tops = out_base + keep_hi
    if len(tops) and int(tops.max()) >= 2 ** 31:
        raise ValueError(
            f"fused output index {int(tops.max())} exceeds int32; coalesce "
            "fewer/smaller requests")
    q0 = np.concatenate(
        [b.q0.astype(np.int64) + int(o)
         for b, o in zip(batches, word_offsets)])
    if len(q0) and int(q0.max()) >= 2 ** 31:
        raise ValueError("fused stream index exceeds int32")
    if any(int(o) % W for o in perm_offsets):
        raise ValueError(
            f"perm_offsets must be multiples of ways={W} (the symbol walk "
            "gathers whole groups)")
    sym_base = np.concatenate(
        [b.sym_bases().astype(np.int64) + int(o)
         for b, o in zip(batches, perm_offsets)])
    if len(sym_base) and int(sym_base.max()) >= 2 ** 31:
        raise ValueError("fused permutation index exceeds int32")
    return WalkBatch(
        k=cat("k"), y=cat("y"), x0=cat("x0"), q0=q0.astype(np.int32),
        g_hi=cat("g_hi"), start=cat("start"), stop=cat("stop"),
        keep_lo=cat("keep_lo"), keep_hi=keep_hi,
        out_base=out_base.astype(np.int32),
        n_steps=max(b.n_steps for b in batches), ways=W,
        sym_base=sym_base.astype(np.int32))


# ---------------------------------------------------------------------------
# Symbol-indexed layout derivation
# ---------------------------------------------------------------------------

def derive_symbol_layout(words: torch.Tensor, k_of_word: torch.Tensor, *,
                         sym_bucket: int) -> torch.Tensor:
    """``words_by_symbol`` from a compacted stream + emission log, on the
    tensors' device; returns int32[sym_bucket].

    ``k_of_word`` is sorted ascending (emission order is ascending flat
    symbol index) with an int32-max padding tail, so the inverse of the
    compaction's offset->symbol select is a search and a gather:
    ``offset_of(i) = searchsorted(k_of_word, i)``, a hit iff
    ``k_of_word[offset] == i``.  Symbols with no emission get 0 (the walk
    never reads them).
    """
    cap = k_of_word.shape[0]
    i = torch.arange(sym_bucket, dtype=k_of_word.dtype,
                     device=k_of_word.device)
    q = torch.searchsorted(k_of_word, i, side="left").clamp(0, cap - 1)
    hit = k_of_word[q] == i
    return torch.where(hit, words[q].to(torch.int32),
                       torch.zeros((), dtype=torch.int32, device=words.device))


def with_symbol_layout(ds: DeviceStream, k_of_word: np.ndarray,
                       n_symbols: int) -> DeviceStream:
    """Attach the symbol-indexed permutation to a stream handle.

    ``k_of_word`` is the content's emission log (one flat symbol index per
    stream word, ascending).  The permutation is derived on the handle's
    device; the returned handle replaces ``ds`` everywhere — the original
    words are untouched (the wire format does not change).
    """
    kw = np.asarray(k_of_word, np.int64).ravel()
    if kw.size != ds.n_words:
        raise ValueError(
            f"emission log covers {kw.size} words but the stream has "
            f"{ds.n_words}")
    if kw.size and (int(kw.min()) < 0 or int(kw.max()) >= n_symbols):
        raise ValueError("emission log indexes outside [0, n_symbols)")
    if np.any(np.diff(kw) <= 0):
        raise ValueError("emission log must be strictly ascending")
    sym_bucket = pow2_bucket(n_symbols, 1024)
    kpad = np.full(ds.bucket, np.iinfo(np.int32).max, np.int32)
    kpad[:kw.size] = kw.astype(np.int32)
    by = derive_symbol_layout(ds.words,
                              torch.as_tensor(kpad, device=ds.words.device),
                              sym_bucket=sym_bucket)
    # u16 permutation variant: every entry is a 16-bit stream word, so the
    # narrow store is exact whenever it exists at all.  Kept u32 for big
    # streams only so the dtype is a pure function of n_words (plan keys
    # include it — no aliasing).  int16 holds the u16 bit patterns.
    if ds.n_words < (1 << 16):
        by = torch.where(by >= 1 << 15, by - (1 << 16), by).to(torch.int16)
    return dataclasses.replace(ds, by_symbol=by, sym_bucket=sym_bucket)


def chunk_bounds(n_rows: int, n_chunks: int) -> list[tuple[int, int]]:
    """Even, contiguous partition of split rows into chunks (the wire
    directory of ``container.pack_recoil_chunked`` uses it)."""
    n_chunks = max(1, min(int(n_chunks), n_rows))
    cuts = [round(n_rows * c / n_chunks) for c in range(n_chunks + 1)]
    return [(cuts[c], cuts[c + 1]) for c in range(n_chunks)]
