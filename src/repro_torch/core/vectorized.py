"""Vectorized rANS codec in torch — group-stepped loops with W parallel lanes.

This is the batched formulation of interleaved rANS (paper §2.2) and of the
Recoil walk (§4.1): one step processes a *symbol group* of W lanes for every
split at once; the only cross-lane interaction is the renormalization read
*offset assignment*, which the paper's CUDA code gets from a warp ballot and
the plain walk here gets from a reversed exclusive cumsum over the lane read
mask (the CUDA kernels in :mod:`repro_torch.kernels.rans_decode` go back to
the ballot).

The walks here are the *plain* versions of those kernels: a Python loop
over steps, batched over splits x lanes, on whatever device the tensors lie
on.  The kernel wrappers take them for CPU tensors; the tests hold them
against the JAX reference walks.  Adaptive models (per-context tables keyed
by the walk index, ``ctx_model=``) run here only, on host tensors: neither
walk kernel handles them, as no reference executor passes a context map.

Unsigned 32-bit states: rANS states are u32 with the top bit live.  Every
tensor that crosses a function boundary holds them as int32 bit patterns
(the form the CUDA kernels take); inside the plain walks they widen to
int64 and are masked to 32 bits after every operation that could wrap, so
the arithmetic is exactly the reference's u32 arithmetic.

Walk-state conventions match :class:`repro_torch.core.interleaved.SplitState`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .interleaved import EncodedStream, SplitState
from .rans import StaticModel, pack_decode_lut

MASK32 = 0xFFFFFFFF
L_BOUND = 1 << 16
B_BITS = 16


# ---------------------------------------------------------------------------
# Encode (host-side group-stepped loop, W lanes)
# ---------------------------------------------------------------------------

def encode_interleaved_fast(symbols: np.ndarray, model: StaticModel,
                            ctx=None, ctx_f=None, ctx_F=None) -> EncodedStream:
    """Bit-exact drop-in for :func:`repro_torch.core.interleaved.encode_interleaved`.

    With (ctx, ctx_f, ctx_F) provided, encodes with per-index distributions
    (adaptive coding): symbol ``i`` takes row ``ctx[i]`` of the ``[C, A]``
    tables — a drop-in for ``adaptive.encode_interleaved_adaptive``.

    This encoder runs on the host on purpose.  Each way's state chain is
    sequential, so the encode has only W lanes of parallelism per step and
    ``G = ceil(N / W)`` dependent steps: a device loop would pay one launch
    per operation per group.  The loop below steps over groups with W-lane
    numpy vectors and records only the pre-renormalization state of every
    lane; which lanes emitted, their words and their bounded states are then
    recovered for the whole stream in a few vectorized passes.  Emitted
    words land in row-major (group, lane) order, which is exactly the
    oracle's emission order.
    """
    if model is None:
        raise ValueError("model required (pass a StaticModel; adaptive uses "
                         "encode_adaptive_fast)")
    p = model.params
    W = p.ways
    syms = np.asarray(symbols, dtype=np.int64).ravel()
    N = len(syms)
    if ctx is None:
        f_sym = model.f.astype(np.int64)[syms]
        F_sym = model.F.astype(np.int64)[syms]
    else:
        c = np.asarray(ctx, np.int64).ravel()[:N]
        f_sym = np.asarray(ctx_f, np.int64)[c, syms]
        F_sym = np.asarray(ctx_F, np.int64)[c, syms]
    if N and np.any(f_sym == 0):
        bad = int(syms[np.flatnonzero(f_sym == 0)[0]])
        raise ValueError(f"symbol {bad} has zero quantized frequency")
    G = -(-N // W) if N else 0
    pad = G * W - N
    # Padding lanes of the last group carry f = 2^n, F = 0, which neither
    # renormalizes (x < 2^32) nor moves the state: their final state stays
    # the last real one, as in the oracle.
    fs = np.concatenate([f_sym, np.full(pad, p.scale, np.int64)])
    Fs = np.concatenate([F_sym, np.zeros(pad, np.int64)])
    fs = fs.reshape(G, W)
    gain = p.scale - fs              # x' = x + (x // f) * (2^n - f) + F
    Fs = Fs.reshape(G, W)
    shift = p.renorm_shift
    xs = np.empty((G, W), np.int64)  # state before each group's renorm
    x = np.full(W, p.lower_bound, np.int64)
    for g in range(G):
        xs[g] = x
        f_g = fs[g]
        x = np.where((x >> shift) >= f_g, x >> B_BITS, x)
        x = x + (x // f_g) * gain[g] + Fs[g]
    flat_x = xs.reshape(-1)[:N]
    emit = (flat_x >> shift) >= fs.reshape(-1)[:N]
    sel = np.flatnonzero(emit)       # row-major == emission order
    emitted = flat_x[sel]
    return EncodedStream(
        stream=(emitted & p.word_mask).astype(np.uint16),
        final_states=x.astype(np.uint32),
        n_symbols=N, params=p,
        k_of_word=sel.astype(np.int64),
        y_of_word=(emitted >> B_BITS).astype(np.uint32))


def encode_adaptive_fast(symbols: np.ndarray, ctx_model) -> EncodedStream:
    """Host group-stepped adaptive encoder (bit-exact vs the python
    oracle ``adaptive.encode_interleaved_adaptive``)."""
    return encode_interleaved_fast(
        symbols,
        StaticModel(f=ctx_model.f[0], F=ctx_model.F[0],
                    params=ctx_model.params),
        ctx=ctx_model.ctx,
        ctx_f=ctx_model.f.astype(np.int32),
        ctx_F=ctx_model.F.astype(np.int32))


# ---------------------------------------------------------------------------
# Walk decode (step loop, batched over splits x lanes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WalkBatch:
    """SoA form of a list of SplitStates, padded to a common step count.

    ``g_hi[m]`` is split m's top group, the walk iterates g = g_hi - t for
    t in [0, n_steps); rows with g < g_lo are inactive padding.

    ``sym_base`` only matters to the symbol-indexed stream layout: row m's
    walk gathers ``words_by_symbol[i + sym_base[m]]``, so it is 0 for a
    standalone content and shifts to the content's window when requests
    fuse over a concatenated permutation.  The pointer layout ignores it
    (``q0`` plays the analogous role there).
    """

    k: np.ndarray        # int32[S, W]
    y: np.ndarray        # uint32[S, W]
    x0: np.ndarray       # uint32[S, W]
    q0: np.ndarray       # int32[S]
    g_hi: np.ndarray     # int32[S]
    start: np.ndarray    # int32[S]
    stop: np.ndarray     # int32[S]
    keep_lo: np.ndarray  # int32[S]
    keep_hi: np.ndarray  # int32[S]
    out_base: np.ndarray  # int32[S] — global output offset (conventional adapter)
    n_steps: int
    ways: int
    sym_base: np.ndarray | None = None  # int32[S] — words_by_symbol gather base

    def sym_bases(self) -> np.ndarray:
        """``sym_base`` with the zero default materialized."""
        if self.sym_base is None:
            return np.zeros(self.k.shape[0], np.int32)
        return self.sym_base

    @classmethod
    def from_splits(cls, splits: list[SplitState], ways: int,
                    out_bases: np.ndarray | None = None) -> "WalkBatch":
        S = len(splits)
        k = np.stack([s.k for s in splits]).astype(np.int32)
        y = np.stack([s.y for s in splits]).astype(np.uint32)
        x0 = np.stack([s.x0 for s in splits]).astype(np.uint32)
        q0 = np.asarray([s.q0 for s in splits], np.int32)
        start = np.asarray([s.start for s in splits], np.int32)
        stop = np.asarray([s.stop for s in splits], np.int32)
        g_hi = start // ways
        g_lo = stop // ways
        n_steps = int((g_hi - g_lo + 1).max()) if S else 0
        if out_bases is None:
            out_base = np.zeros(S, np.int32)
        else:
            # The device scatter indexes with int32: global positions
            # (out_base + local index) must fit, so fail loudly here instead
            # of wrapping in the kernel.
            out_bases = np.asarray(out_bases)
            tops = out_bases + np.asarray([s.keep_hi for s in splits])
            if S and int(tops.max()) >= 2 ** 31:
                raise ValueError(
                    f"global output index {int(tops.max())} exceeds int32; "
                    ">2^31-symbol batches are not supported by the device "
                    "scatter")
            out_base = out_bases.astype(np.int32)
        return cls(
            k=k, y=y, x0=x0, q0=q0, g_hi=g_hi.astype(np.int32),
            start=start, stop=stop,
            keep_lo=np.asarray([s.keep_lo for s in splits], np.int32),
            keep_hi=np.asarray([s.keep_hi for s in splits], np.int32),
            out_base=out_base, n_steps=n_steps, ways=ways)


def lut_arrays(model: StaticModel, packed: bool) -> tuple:
    """Slot tables as int32 numpy arrays: ``(packed, None, None)`` under the
    §4.4 packed layout (sym[0:8] | f[8:20] | F[20:32]), else the three
    slot-indexed tables ``(symbol, f, F)``."""
    if packed:
        return (pack_decode_lut(model.f, model.F), None, None)
    lut = model.slot_lut()
    return (lut.astype(np.int32), model.f.astype(np.int32)[lut],
            model.F[:-1].astype(np.int32)[lut])


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 (or int16) bit pattern -> its unsigned value, as int64."""
    mask = 0xFFFF if t.dtype == torch.int16 else MASK32
    return t.to(torch.int64) & mask


def _slot_decode(sym_lut: torch.Tensor, f_lut: torch.Tensor | None,
                 F_lut: torch.Tensor | None, slot: torch.Tensor,
                 i: torch.Tensor, ctx_of_index: torch.Tensor | None):
    """slot -> (symbol, f, F) as int64 under the three table layouts: the
    §4.4 packed single-int32 word (one gather, bitwise unpack), the three
    split static tables, or adaptive per-context ``[C, 2^n]`` tables keyed
    by the walk index ``i`` (``ctx_of_index[i]`` picks the row).  Shared by
    the pointer and symbol-layout walks so the bit layout lives in ONE
    place on the torch side (the kernels' twin, static tables only, is
    ``slot_decode`` in ``csrc/rans_walk.cu``)."""
    if ctx_of_index is None and f_lut is None:
        packed = _u32(sym_lut[slot])
        return packed & 0xFF, (packed >> 8) & 0xFFF, (packed >> 20) & 0xFFF
    if ctx_of_index is None:
        return (sym_lut[slot].to(torch.int64), f_lut[slot].to(torch.int64),
                F_lut[slot].to(torch.int64))
    c = ctx_of_index[i.clamp(0, ctx_of_index.shape[0] - 1)].to(torch.int64)
    return (sym_lut[c, slot].to(torch.int64),
            f_lut[c, slot].to(torch.int64), F_lut[c, slot].to(torch.int64))


def _scatter_kept(syms: torch.Tensor, keeps: torch.Tensor,
                  g_hi: torch.Tensor, out_base: torch.Tensor, *, ways: int,
                  n_steps: int, n_symbols: int) -> torch.Tensor:
    """Closed-form output scatter shared by both walk layouts: the symbol
    decoded at step t, lane j of split m lands at ``(g_hi[m] - t) * W + j +
    out_base[m]``.  Kept positions are unique by construction (disjoint
    [keep_lo, keep_hi) ranges); positions outside [0, n_symbols) are
    dropped.  Returns int32[n_symbols] with -1 where nothing was kept."""
    dev = syms.device
    lanes = torch.arange(ways, dtype=torch.int64, device=dev)
    t = torch.arange(n_steps, dtype=torch.int64, device=dev)
    i = ((g_hi.to(torch.int64)[:, None, None] - t[None, :, None]) * ways
         + lanes[None, None, :] + out_base.to(torch.int64)[:, None, None])
    sel = keeps & (i >= 0) & (i < n_symbols)
    out = torch.full((n_symbols,), -1, dtype=torch.int32, device=dev)
    out[i[sel]] = syms[sel].to(torch.int32)
    return out


def _split_columns(g_hi, start, stop, keep_lo, keep_hi):
    return tuple(a.to(torch.int64)[:, None]
                 for a in (g_hi, start, stop, keep_lo, keep_hi))


def _walk_pointer_tiles(stream, sym_lut, f_lut, F_lut, k, y, x0, q0, g_hi,
                        start, stop, keep_lo, keep_hi, *, n_bits: int,
                        ways: int, n_steps: int, ctx_of_index=None):
    """Plain pointer-layout walk over every split at once.

    Returns ``(syms int64[S, T, W], keeps bool[S, T, W], qf int64[S])``:
    the symbol each lane decoded at each step, whether it is kept, and each
    split's final stream pointer.  The per-step recurrence is the
    reference's ``_walk_one_split``:

        reconstruct (i == k_j):  x_j = (y_j << 16) | word
        decode      (i <  k_j):  x = f·(x >> n) + slot − F, renorm read if
                                 x < 2^16

    and lane j's word index is ``q`` minus the reads of higher lanes in its
    split (decode order is descending lane within a group).
    ``ctx_of_index`` (int32[N]) selects adaptive per-context tables.
    """
    dev = k.device
    S, W = k.shape
    lanes = torch.arange(W, dtype=torch.int64, device=dev)
    words = _u32(stream)
    n_words = words.shape[0]
    slot_mask = (1 << n_bits) - 1
    k = k.to(torch.int64)
    yb = (_u32(y) << B_BITS) & MASK32
    x = _u32(x0)
    q = q0.to(torch.int64)[:, None]
    g_hi, start, stop, keep_lo, keep_hi = _split_columns(
        g_hi, start, stop, keep_lo, keep_hi)
    syms = torch.empty((S, n_steps, W), dtype=torch.int64, device=dev)
    keeps = torch.empty((S, n_steps, W), dtype=torch.bool, device=dev)
    for t in range(n_steps):
        g = g_hi - t
        i = g * W + lanes
        active = (i <= start) & (i >= stop) & (g >= 0)
        recon = active & (i == k)
        dec = active & (i < k)
        slot = x & slot_mask
        s, fs, Fs = _slot_decode(sym_lut, f_lut, F_lut, slot, i,
                                 ctx_of_index)
        x_dec = (fs * (x >> n_bits) + (slot - Fs)) & MASK32
        under = x_dec < L_BOUND
        rd = (recon | (dec & under)).to(torch.int64)
        total = rd.sum(dim=1, keepdim=True)
        idx = (q - (total - rd.cumsum(dim=1))).clamp(0, n_words - 1)
        word = words[idx]
        x_dec2 = torch.where(under, ((x_dec << B_BITS) & MASK32) | word,
                             x_dec)
        x = torch.where(recon, yb | word, torch.where(dec, x_dec2, x))
        q = q - total
        syms[:, t] = s
        keeps[:, t] = dec & (i >= keep_lo) & (i < keep_hi)
    return syms, keeps, q[:, 0]


def _walk_batch_impl(stream, sym_lut, f_lut, F_lut, k, y, x0, q0, g_hi, start,
                     stop, keep_lo, keep_hi, out_base, *, n_bits, ways,
                     n_steps, n_symbols, ctx_of_index=None):
    """Plain pointer-layout decode: walk + closed-form scatter.  Returns
    ``(out int32[n_symbols], qf int32[S])``; the argument order is the
    plan's (``engine.plan.SPLIT_FIELDS``)."""
    syms, keeps, qf = _walk_pointer_tiles(
        stream, sym_lut, f_lut, F_lut, k, y, x0, q0, g_hi, start, stop,
        keep_lo, keep_hi, n_bits=n_bits, ways=ways, n_steps=n_steps,
        ctx_of_index=ctx_of_index)
    out = _scatter_kept(syms, keeps, g_hi, out_base, ways=ways,
                        n_steps=n_steps, n_symbols=n_symbols)
    return out, qf.to(torch.int32)


# ---------------------------------------------------------------------------
# Symbol-indexed stream layout: pointer-free walk
# ---------------------------------------------------------------------------
#
# The emission-log bijection (interleaved.py header): the word at stream
# offset q is consumed by the renorm-read that follows the decode of symbol
# k_of_word[q] — and recon reads at i == k[j] consume the word emitted at
# k[j] (the split metadata's k[j] IS an emission).  So every read the walk
# ever issues while processing symbol i fetches stream[offset_of_emission(i)].
# Pre-permuting the stream into ``words_by_symbol[i]`` therefore lets each
# lane gather its word by its own symbol index: the sequential stream
# pointer q and the per-step cross-lane renormalization count both leave
# the carry, which shrinks to just the W rANS states.


def words_by_symbol_host(stream: np.ndarray, k_of_word: np.ndarray,
                         n_symbols: int) -> np.ndarray:
    """Host-side symbol-indexed re-layout: ``out[i]`` is the word emitted at
    flat symbol index ``i`` (0 where symbol ``i`` emitted nothing).  The
    device derivation lives in ``core.engine.plan``; this is the oracle."""
    kw = np.asarray(k_of_word, np.int64)
    words = np.ascontiguousarray(stream)
    if words.size != kw.size:
        raise ValueError(
            f"emission log covers {kw.size} words, stream has {words.size}")
    out = np.zeros(n_symbols, np.uint32)
    if kw.size:
        if int(kw.min()) < 0 or int(kw.max()) >= n_symbols:
            raise ValueError("emission log indexes outside [0, n_symbols)")
        out[kw] = words.astype(np.uint32)
    return out


def _walk_symbol_tiles(by_symbol, sym_lut, f_lut, F_lut, k, y, x0, sym_base,
                       g_hi, start, stop, keep_lo, keep_hi, *, n_bits: int,
                       ways: int, n_steps: int, ctx_of_index=None):
    """Plain pointer-free walk over every split at once; returns
    ``(syms int64[S, T, W], keeps bool[S, T, W])``.

    Identical decode math to :func:`_walk_pointer_tiles`, but the words for
    the group at symbol indices ``g*W + sym_base + [0, W)`` are row
    ``g + sym_base/W`` of the permutation viewed (G, W).  ``by_symbol`` is
    int16 (u16 bit patterns, small assets) or int32 (u32 bit patterns).
    """
    dev = k.device
    S, W = k.shape
    if by_symbol.shape[0] % W:
        raise ValueError(
            f"words_by_symbol length {by_symbol.shape[0]} is not a multiple "
            f"of ways={W}")
    n_groups = by_symbol.shape[0] // W
    lanes = torch.arange(W, dtype=torch.int64, device=dev)
    words = _u32(by_symbol)
    slot_mask = (1 << n_bits) - 1
    k = k.to(torch.int64)
    yb = (_u32(y) << B_BITS) & MASK32
    x = _u32(x0)
    row0 = g_hi.to(torch.int64) + sym_base.to(torch.int64) // W
    g_hi, start, stop, keep_lo, keep_hi = _split_columns(
        g_hi, start, stop, keep_lo, keep_hi)
    syms = torch.empty((S, n_steps, W), dtype=torch.int64, device=dev)
    keeps = torch.empty((S, n_steps, W), dtype=torch.bool, device=dev)
    for t in range(n_steps):
        g = g_hi - t
        i = g * W + lanes
        active = (i <= start) & (i >= stop) & (g >= 0)
        recon = active & (i == k)
        dec = active & (i < k)
        slot = x & slot_mask
        s, fs, Fs = _slot_decode(sym_lut, f_lut, F_lut, slot, i,
                                 ctx_of_index)
        x_dec = (fs * (x >> n_bits) + (slot - Fs)) & MASK32
        under = x_dec < L_BOUND
        row = (row0 - t).clamp(0, n_groups - 1)
        word = words[row[:, None] * W + lanes]
        x_dec2 = torch.where(under, ((x_dec << B_BITS) & MASK32) | word,
                             x_dec)
        x = torch.where(recon, yb | word, torch.where(dec, x_dec2, x))
        syms[:, t] = s
        keeps[:, t] = dec & (i >= keep_lo) & (i < keep_hi)
    return syms, keeps


def _walk_batch_symbol_impl(by_symbol, sym_lut, f_lut, F_lut, k, y, x0,
                            sym_base, g_hi, start, stop, keep_lo, keep_hi,
                            out_base, *, n_bits, ways, n_steps, n_symbols,
                            ctx_of_index=None):
    """Plain symbol-layout decode: walk + closed-form scatter.  Returns
    int32[n_symbols]; the argument order is the plan's
    (``engine.plan.SYMBOL_SPLIT_FIELDS``)."""
    syms, keeps = _walk_symbol_tiles(
        by_symbol, sym_lut, f_lut, F_lut, k, y, x0, sym_base, g_hi, start,
        stop, keep_lo, keep_hi, n_bits=n_bits, ways=ways, n_steps=n_steps,
        ctx_of_index=ctx_of_index)
    return _scatter_kept(syms, keeps, g_hi, out_base, ways=ways,
                         n_steps=n_steps, n_symbols=n_symbols)


# ---------------------------------------------------------------------------
# Host-facing plain decodes (CPU, numpy in and out)
# ---------------------------------------------------------------------------

def _cpu(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU torch, with u32 arrays as their int32 bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a)


def _cpu_luts(model: StaticModel, packed_lut: bool) -> tuple:
    return tuple(None if a is None else torch.from_numpy(a)
                 for a in lut_arrays(model, packed_lut))


def _cpu_tables(model: StaticModel, packed_lut: bool, ctx_model) -> tuple:
    """The walk's slot tables and context map on the CPU: ``(luts,
    n_bits, ctx_of_index)``.  A ``ctx_model`` (adaptive) gives per-context
    ``[C, 2^n]`` tables and its int32 context map, and ``model`` is then
    ignored."""
    if ctx_model is None:
        return _cpu_luts(model, packed_lut), model.params.n_bits, None
    slots = ctx_model.slot_luts()
    slot_f = np.take_along_axis(ctx_model.f.astype(np.int32), slots, axis=1)
    slot_F = np.take_along_axis(ctx_model.F[:, :-1].astype(np.int32), slots,
                                axis=1)
    luts = tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                 for a in (slots, slot_f, slot_F))
    return (luts, ctx_model.params.n_bits,
            torch.from_numpy(ctx_model.ctx.astype(np.int32)))


def _checked(out: torch.Tensor, what: str) -> np.ndarray:
    res = out.numpy().astype(np.int64)
    if not (res >= 0).all():
        raise RuntimeError(f"{what} left uncovered symbols")
    return res


def walk_decode_batch(batch: WalkBatch, stream: np.ndarray, model: StaticModel,
                      n_symbols: int, ctx_model=None,
                      packed_lut: bool = False) -> np.ndarray:
    """Decode all splits with the plain pointer walk on the CPU.

    ``ctx_model`` switches to adaptive (index-keyed) distributions; pass a
    :class:`repro_torch.core.adaptive.ContextModel` (then ``model`` is
    ignored).  ``packed_lut`` uses the paper §4.4 single-int32 slot table
    (n <= 12, 8-bit symbols): one gather per step instead of three.
    """
    if n_symbols >= 2 ** 31:
        raise ValueError(
            f"n_symbols={n_symbols} exceeds int32 device-scatter indices")
    words = np.ascontiguousarray(stream).astype(np.int32)
    luts, n_bits, ctx = _cpu_tables(model, packed_lut, ctx_model)
    out, _ = _walk_batch_impl(
        torch.from_numpy(words), *luts,
        _cpu(batch.k), _cpu(batch.y), _cpu(batch.x0), _cpu(batch.q0),
        _cpu(batch.g_hi), _cpu(batch.start), _cpu(batch.stop),
        _cpu(batch.keep_lo), _cpu(batch.keep_hi), _cpu(batch.out_base),
        n_bits=n_bits, ways=batch.ways, n_steps=batch.n_steps,
        n_symbols=n_symbols, ctx_of_index=ctx)
    return _checked(out, "pointer walk")


def walk_decode_batch_symbol(batch: WalkBatch, by_symbol: np.ndarray,
                             model: StaticModel, n_symbols: int,
                             ctx_model=None,
                             packed_lut: bool = False) -> np.ndarray:
    """Pointer-free decode of all splits on the CPU (symbol-indexed layout).

    ``by_symbol`` is the :func:`words_by_symbol_host` permutation (or any
    padding of it).  Same contract as :func:`walk_decode_batch`; the two are
    bit-exact by the emission-log bijection.
    """
    if n_symbols >= 2 ** 31:
        raise ValueError(
            f"n_symbols={n_symbols} exceeds int32 device-scatter indices")
    bases = batch.sym_bases()
    if bases.size and np.any(bases % batch.ways):
        raise ValueError("sym_base entries must be multiples of ways")
    wbs = np.ascontiguousarray(by_symbol).astype(np.uint32)
    pad = (-len(wbs)) % batch.ways
    if pad:
        wbs = np.concatenate([wbs, np.zeros(pad, np.uint32)])
    luts, n_bits, ctx = _cpu_tables(model, packed_lut, ctx_model)
    out = _walk_batch_symbol_impl(
        _cpu(wbs), *luts,
        _cpu(batch.k), _cpu(batch.y), _cpu(batch.x0), _cpu(bases),
        _cpu(batch.g_hi), _cpu(batch.start), _cpu(batch.stop),
        _cpu(batch.keep_lo), _cpu(batch.keep_hi), _cpu(batch.out_base),
        n_bits=n_bits, ways=batch.ways, n_steps=batch.n_steps,
        n_symbols=n_symbols, ctx_of_index=ctx)
    return _checked(out, "symbol-layout walk")


def decode_recoil_fast(plan, stream, final_states, model: StaticModel,
                       ctx_model=None) -> np.ndarray:
    from .recoil import build_split_states
    splits = build_split_states(plan, final_states)
    batch = WalkBatch.from_splits(splits, plan.ways)
    return walk_decode_batch(batch, stream, model, plan.n_symbols, ctx_model)


def decode_conventional_fast(conv, model: StaticModel) -> np.ndarray:
    from .conventional import to_split_states
    splits, words, out_bases = to_split_states(conv)
    W = conv.partitions[0].params.ways
    batch = WalkBatch.from_splits(splits, W, out_bases)
    return walk_decode_batch(batch, words, model, conv.n_symbols)
