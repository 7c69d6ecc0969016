"""DecodePlan IR: a decode request, prepared once into executor-ready form.

    WalkBatch + DeviceStream + n_symbols
        --executor.plan()-->  DecodePlan          (host work, per request)
        --session cache[plan.key]-->  launcher    (resolved only on miss)
        --executor.run(fn, plan)-->  device syms  (no host round-trip)

A :class:`DecodePlan` captures everything the launch needs:

  * ``key``      — the plan-cache key.  Two plans with equal keys run the
                   same launcher at the same bucketed shapes (all bucketed
                   dims equal, same backend/LUT/layout config);
  * ``args``     — the positional argument tuple (the resident stream at
                   its bucket, the request's real split rows), placed on
                   the session's device;
  * ``statics``  — the launch's scalar arguments that every plan of the
                   key shares (``n_bits``, ``ways``), bound once per key;
  * ``n_steps``, ``n_symbols``, ``covered`` — the request's real walk
                   depth, output length and whether the kept windows tile
                   the output; the executor passes them at run time, since
                   plans of one key share one launcher;
  * ``ready``    — on the card, an event recorded on the stream that wrote
                   ``args`` right after it wrote them (None elsewhere): a
                   walk on another stream waits for it.

Bucketing policy: a pluggable :class:`BucketPolicy` pads memory-dominant
dims through ``policy.mem`` and compute-dominant dims through
``policy.work``; the default :data:`LEGACY_POLICY` is powers of two
(:func:`pow2_bucket`) and powers of two with their 1.5x midpoints
(:func:`work_bucket`).  The buckets and ``policy.tag`` join the key; only
the resident stream is padded (to its pow2 bucket, whatever the policy),
and that padding is inert by construction — extra stream words are never
indexed.  Split rows, walk steps and the output keep their real sizes.

:func:`concat_walk_batches` is the microbatch fusion primitive: N requests'
WalkBatches become one batch whose per-request rows write disjoint output
windows (``out_base`` shifted by each request's symbol offset) and read
disjoint stream windows (``q0`` shifted by each stream's word offset in a
fused stream, when requests target different contents).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
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


# ---------------------------------------------------------------------------
# Bucket policies: the ladder is pluggable
# ---------------------------------------------------------------------------

class BucketPolicy:
    """Pluggable bucket ladder for plan-cache shape quantization.

    An executor asks its policy for two kinds of buckets: ``work(n)`` for
    compute-dominant dims (walk steps, split rows, encode groups) and
    ``mem(n)`` for memory-dominant dims (output slots).  Contract, relied
    on by every executor and property-tested in
    ``tests/test_torch_tuning.py``:

      * **coverage** — ``work(n, floor) >= max(n, floor, 1)`` (same for
        ``mem``): padding never truncates;
      * **monotone** — ``n1 <= n2`` implies ``bucket(n1) <= bucket(n2)``;
      * **idempotent** — ``bucket(bucket(n)) == bucket(n)``: bucket values
        are fixpoints, so re-bucketing a padded dim is a no-op;
      * **pure** — the result depends only on ``(n, floor)``; two requests
        with equal dims always share one launcher.

    ``tag`` joins every plan-cache key, so two policies that happen to
    agree on some bucket values still never alias one session's launchers
    against another ladder's bucket assumptions.
    """

    tag: str = "?"

    def work(self, n: int, floor: int = 1) -> int:
        raise NotImplementedError

    def mem(self, n: int, floor: int = 1) -> int:
        raise NotImplementedError


class LegacyBucketPolicy(BucketPolicy):
    """The hand-picked seed ladder: pow2 memory dims, pow2 + 1.5x-midpoint
    work dims.  The default wherever no tuned profile is supplied —
    behaviorally identical to the pre-policy engine."""

    tag = "legacy"

    def work(self, n: int, floor: int = 1) -> int:
        return work_bucket(n, floor)

    def mem(self, n: int, floor: int = 1) -> int:
        return pow2_bucket(n, floor)


class LadderBucketPolicy(BucketPolicy):
    """Explicit-breakpoint ladder (tuned profiles, ``core.tuning``).

    ``work_ladder`` / ``mem_ladder`` are ascending rung values; a request
    dim buckets to the smallest rung >= it.  Above the top rung the policy
    falls back to the legacy ladder (clamped >= the top rung, so the
    boundary stays monotone); an empty ``mem_ladder`` keeps memory dims on
    pure pow2.  ``tag`` defaults to a content hash of both ladders, so the
    plan-cache key pins the exact ladder that shaped the plan.
    """

    def __init__(self, work_ladder: Sequence[int],
                 mem_ladder: Sequence[int] = (), tag: str | None = None):
        self.work_ladder = tuple(sorted({int(v) for v in work_ladder}))
        self.mem_ladder = tuple(sorted({int(v) for v in mem_ladder}))
        if not self.work_ladder:
            raise ValueError("work_ladder needs at least one rung")
        for ladder in (self.work_ladder, self.mem_ladder):
            if ladder and ladder[0] < 1:
                raise ValueError(f"ladder rungs must be >= 1, got {ladder}")
        if tag is None:
            digest = hashlib.sha1(
                repr((self.work_ladder, self.mem_ladder)).encode()
            ).hexdigest()[:10]
            tag = f"ladder:{digest}"
        self.tag = tag

    @staticmethod
    def _bucket(ladder: tuple, n: int, floor: int, fallback) -> int:
        n = max(int(n), int(floor), 1)
        if ladder and n <= ladder[-1]:
            return ladder[bisect.bisect_left(ladder, n)]
        v = fallback(n)
        return max(v, ladder[-1]) if ladder else v

    def work(self, n: int, floor: int = 1) -> int:
        return self._bucket(self.work_ladder, n, floor, work_bucket)

    def mem(self, n: int, floor: int = 1) -> int:
        return self._bucket(self.mem_ladder, n, floor, pow2_bucket)


def legacy_rungs(lo: int, hi: int) -> list[int]:
    """Every legacy work rung (2^k and 1.5 * 2^k) in ``[lo, hi]`` — the
    base a tuned ladder unions with its measured breakpoints so dims the
    tuner never observed keep seed-ladder padding."""
    out, p = [], 1
    while p <= hi:
        for v in (p, p + p // 2):
            if lo <= v <= hi and v not in out[-2:]:
                out.append(v)
        p *= 2
    return out


#: Shared default: module-level so "no policy" means ONE policy object (and
#: one tag) everywhere, not per-session lookalikes.
LEGACY_POLICY = LegacyBucketPolicy()


@dataclasses.dataclass(frozen=True)
class DeviceStream:
    """A stream registered with a session, resident on its device.

    ``words`` holds the 16-bit stream words as int16 bit patterns,
    zero-padded to the pow2 ``bucket``; ``host`` keeps the original words
    (``None`` for fused streams built by the microbatcher).

    ``by_symbol`` is the symbol-indexed permutation of the same words:
    entry ``i`` is the word emitted at flat symbol index ``i`` (0 where
    symbol ``i`` emitted nothing), padded to ``sym_bucket``, as int16 bit
    patterns: every entry is a 16-bit stream word, whatever the stream's
    length.  It exists only for content whose emission log was available at
    registration; ``None`` keeps the handle on the pointer walk.  The wire
    format never carries it.
    """

    words: torch.Tensor           # int16[bucket], zero-padded tail
    host: np.ndarray | None       # uint16/uint32[n_words] — original words
    n_words: int
    bucket: int
    by_symbol: torch.Tensor | None = None   # int16[sym_bucket]
    sym_bucket: int = 0


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
    covered: bool = False     # kept windows tile [0, n_symbols)
    n_steps: int = 0          # the request's real walk depth
    ready: object = dataclasses.field(default=None, compare=False)


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


def kept_windows_tile(batch: WalkBatch, n_symbols: int) -> bool:
    """Whether the walk writes every output position of ``[0, n_symbols)``
    exactly once: the kept windows ``[out_base + keep_lo, out_base +
    keep_hi)`` of the batch's rows, empty ones aside, tile the range, and
    every kept symbol is one its split decodes (``stop <= keep_lo``,
    ``keep_hi <= start + 1`` and ``keep_hi <= min_j k_j``).  Host work,
    once per plan."""
    lo = batch.out_base.astype(np.int64) + batch.keep_lo
    hi = batch.out_base.astype(np.int64) + batch.keep_hi
    some = hi > lo
    if not some.any():
        return n_symbols == 0
    decoded = ((batch.keep_lo >= batch.stop)
               & (batch.keep_hi <= batch.start.astype(np.int64) + 1)
               & (batch.keep_hi <= batch.k.min(axis=1)))
    if not decoded[some].all():
        return False
    order = np.argsort(lo[some], kind="stable")
    lo, hi = lo[some][order], hi[some][order]
    return bool(lo[0] == 0 and hi[-1] == n_symbols
                and np.array_equal(lo[1:], hi[:-1]))


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
    tensors' device; returns the unsigned words as int32[sym_bucket]
    (``words`` may hold them as int16 or int32 bit patterns).

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
    return torch.where(hit, words[q].to(torch.int32) & 0xFFFF,
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
    # Every entry is a 16-bit stream word, so the u16 store is exact at any
    # stream length; int16 holds the u16 bit patterns.
    by = torch.where(by >= 1 << 15, by - (1 << 16), by).to(torch.int16)
    return dataclasses.replace(ds, by_symbol=by, sym_bucket=sym_bucket)


# ---------------------------------------------------------------------------
# Chunk axis: streaming decode over split-row windows
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    """One chunk of a chunked decode: split rows ``[r0, r1)`` of the full
    WalkBatch, rebased to write output window ``[0, length)``.

    ``base``/``length`` locate the chunk in the content's symbol space
    (``out[base : base + length]`` of the whole-asset decode).  The rebased
    ``out_base`` is negative for every chunk after the first — the walks
    drop positions below 0, and only kept symbols (which land in range)
    are written.  ``words_end`` is the stream-prefix requirement: chunk
    rows read word offsets ``<= words_end - 1`` only, so the chunk is
    decodable once the first ``words_end`` words have arrived (the wire
    directory in ``core.container`` carries exactly these cumulative
    counts).
    """

    batch: WalkBatch
    base: int
    length: int
    words_end: int


def chunk_bounds(n_rows: int, n_chunks: int) -> list[tuple[int, int]]:
    """Even, contiguous partition of split rows into chunks.  Shared by the
    serving plans and the wire directory of
    ``container.pack_recoil_chunked`` so both agree on boundaries."""
    n_chunks = max(1, min(int(n_chunks), n_rows))
    cuts = [round(n_rows * c / n_chunks) for c in range(n_chunks + 1)]
    return [(cuts[c], cuts[c + 1]) for c in range(n_chunks)]


def chunk_walk_batch(batch: WalkBatch, n_symbols: int,
                     n_chunks: int) -> list[ChunkSpec]:
    """Slice a whole-asset WalkBatch along the chunk axis.

    Rows are completion-ordered (``build_split_states``), so contiguous row
    runs keep contiguous, ascending symbol windows; chunk c's output is
    exactly ``out[keep_lo[r0] : keep_hi[r1 - 1]]`` of the full decode and
    its step count is recomputed from its own rows (early chunks of a deep
    asset run far fewer steps than the whole-asset walk).  Requires an
    un-fused batch (``out_base == 0``): chunking happens per content,
    before any microbatch fusion.
    """
    S = batch.k.shape[0]
    if batch.out_base.any():
        raise ValueError("chunking expects an un-fused batch (out_base == 0)")
    if int(batch.keep_hi[-1]) != n_symbols:
        raise ValueError(
            f"batch covers [0, {int(batch.keep_hi[-1])}) but n_symbols="
            f"{n_symbols}")
    W = batch.ways
    specs = []
    for r0, r1 in chunk_bounds(S, n_chunks):
        base = int(batch.keep_lo[r0])
        length = int(batch.keep_hi[r1 - 1]) - base
        rows = slice(r0, r1)
        g_hi = batch.g_hi[rows]
        stop = batch.stop[rows]
        n_steps = int((g_hi - stop // W + 1).max())
        sub = WalkBatch(
            k=batch.k[rows], y=batch.y[rows], x0=batch.x0[rows],
            q0=batch.q0[rows], g_hi=g_hi, start=batch.start[rows],
            stop=stop, keep_lo=batch.keep_lo[rows],
            keep_hi=batch.keep_hi[rows],
            out_base=np.full(r1 - r0, -base, np.int32),
            n_steps=n_steps, ways=W,
            sym_base=(None if batch.sym_base is None
                      else batch.sym_base[rows]))
        specs.append(ChunkSpec(batch=sub, base=base, length=length,
                               words_end=int(batch.q0[rows].max()) + 1))
    return specs
