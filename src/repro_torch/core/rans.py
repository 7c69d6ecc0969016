"""rANS primitives: parameters, quantized distributions, LUTs.

Implements Definitions 2.1/2.2 of the paper (state transform + renormalization)
with the recommended Table 3 parameters:

    state        32 bits (uint32 everywhere; all arithmetic is overflow-free, see below)
    symbols      8 or 16 bits
    L            2^16    (renormalization lower bound)
    b            16 bits (renorm output word)
    n            <= 16   (PDF/CDF quantization level)
    ways         32      (interleave width; one warp per split on the GPU)

Overflow-free uint32 arithmetic
-------------------------------
Encode renorm check  ``x >= f << (32-n)``  is evaluated as ``(x >> (32-n)) >= f``
(the shifted threshold itself can overflow uint32 when f == 2^n).
Encode transform     ``x' = ((x/f) << n) + F + x%f``: post-renorm ``x < f·2^(32-n)``
so ``x/f < 2^(32-n)`` and the shift cannot overflow; the tail is ``< 2^n``.
Decode transform     ``x' = f·(x>>n) + (slot - F)`` with ``slot >= F`` — the result
equals a valid encoder state, hence ``< 2^32``.
Decode renorm        ``x < L  =>  x = (x << b) | word`` with ``x < 2^16``.

The requirement ``b >= n`` guarantees renormalization completes in exactly one
step (paper §4.4 / Giesen), which every performance path here assumes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RansParams:
    """Static codec parameters (paper Table 3)."""

    n_bits: int = 11          # PDF/CDF quantization level n
    b_bits: int = 16          # renorm output size b
    l_bits: int = 16          # log2 of renormalization lower bound L
    ways: int = 32            # number of interleaved coders (E/D)

    def __post_init__(self):
        if not (1 <= self.n_bits <= 16):
            raise ValueError(f"n_bits must be in [1, 16], got {self.n_bits}")
        if self.b_bits < self.n_bits:
            raise ValueError(
                "b >= n required so renormalization completes in one step "
                f"(got b={self.b_bits}, n={self.n_bits})")
        if self.b_bits != 16 or self.l_bits != 16:
            raise ValueError("this implementation fixes b = l = 16 (paper Table 3)")
        if self.ways < 1:
            raise ValueError("ways must be >= 1")

    @property
    def scale(self) -> int:
        """2^n — total quantized probability mass."""
        return 1 << self.n_bits

    @property
    def slot_mask(self) -> int:
        return self.scale - 1

    @property
    def lower_bound(self) -> int:
        """L — renormalization lower bound (Def 2.2)."""
        return 1 << self.l_bits

    @property
    def word_mask(self) -> int:
        return (1 << self.b_bits) - 1

    @property
    def renorm_shift(self) -> int:
        """k such that the encode renorm check is ``(x >> k) >= f``."""
        return 32 - self.n_bits


DEFAULT_PARAMS = RansParams()


def quantize_pdf(counts: np.ndarray, n_bits: int) -> np.ndarray:
    """Quantize symbol counts to frequencies summing to exactly 2^n.

    Every symbol with a nonzero count receives f >= 1 (otherwise it could not
    be coded). Deficit/surplus after flooring is distributed to the largest
    frequencies, which minimizes the relative rate damage.
    """
    counts = np.asarray(counts, dtype=np.float64)
    if counts.ndim != 1:
        raise ValueError("counts must be 1-D (one entry per alphabet symbol)")
    scale = 1 << n_bits
    if np.count_nonzero(counts) > scale:
        raise ValueError(
            f"alphabet has {np.count_nonzero(counts)} used symbols; "
            f"cannot quantize to 2^{n_bits} slots")
    total = counts.sum()
    if total <= 0:
        raise ValueError("counts must have positive mass")
    f = np.floor(counts / total * scale).astype(np.int64)
    f[(counts > 0) & (f == 0)] = 1
    # Redistribute to hit the exact total, adjusting the biggest bins: each
    # pass walks the bins by descending f (np.argsort(-f)'s order) and moves
    # each by one until the total is met, skipping bins at 1 when taking
    # away.  A bin's eligibility is fixed for the pass (only the bin itself
    # moves when it is visited), so a pass is the first |diff| eligible bins
    # of the order, as one vector update (the reference's Python loop over
    # the alphabet takes about a minute on a 49,155-symbol vocabulary).
    diff = scale - int(f.sum())
    while diff != 0:
        order = np.argsort(-f)
        step = 1 if diff > 0 else -1
        if step < 0:
            order = order[f[order] > 1]
        chosen = order[:abs(diff)]
        f[chosen] += step
        diff -= step * len(chosen)
    assert f.sum() == scale
    return f.astype(np.uint32)


def build_cdf(f: np.ndarray) -> np.ndarray:
    """Exclusive CDF: F[t] = sum_{u<t} f[u]; length len(f)+1, F[-1] = 2^n."""
    f = np.asarray(f, dtype=np.uint32)
    out = np.zeros(len(f) + 1, dtype=np.uint32)
    np.cumsum(f, out=out[1:], dtype=np.uint32)
    return out


def build_slot_lut(f: np.ndarray, F: np.ndarray) -> np.ndarray:
    """slot -> symbol lookup table over 2^n slots (Eq. 2 symbol search)."""
    scale = int(F[-1])
    lut = np.zeros(scale, dtype=np.int32)
    for s in range(len(f)):
        lo, hi = int(F[s]), int(F[s + 1])
        if hi > lo:
            lut[lo:hi] = s
    return lut


def pack_decode_lut(f: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Pack (symbol, f(s), F(s)) per slot into one int32 (paper §4.4 trick).

    Layout (LSB first): symbol[0:12] | f[12:29]... — the paper packs 8-bit
    symbols with n <= 12 into 32 bits.  We need a layout that also serves the
    CUDA kernels for n <= 12 and 16-bit symbols, so we use two tables when
    n > 12 and the packed one otherwise:

        packed = symbol | (f << 8) | (F << 20)      (8-bit symbols, n <= 12)

    Returns an int32[2^n] array. Raises if the layout does not fit.
    """
    scale = int(F[-1])
    n_bits = int(scale).bit_length() - 1
    if len(f) > 256 or n_bits > 12:
        raise ValueError("packed LUT requires 8-bit symbols and n <= 12")
    lut = build_slot_lut(f, F)
    fs = np.asarray(f, dtype=np.int64)[lut]
    Fs = np.asarray(F, dtype=np.int64)[lut]
    packed = lut.astype(np.int64) | (fs << 8) | (Fs << 20)
    assert packed.max() < (1 << 32)
    return packed.astype(np.uint32).view(np.int32)


def unpack_decode_lut(packed: np.ndarray):
    """Inverse of :func:`pack_decode_lut` -> (symbol, f, F) int32 arrays."""
    p = packed.view(np.uint32).astype(np.int64)
    return (p & 0xFF).astype(np.int32), ((p >> 8) & 0xFFF).astype(np.int32), (
        (p >> 20) & 0xFFF).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class StaticModel:
    """A static quantized symbol distribution (one table for the whole stream)."""

    f: np.ndarray          # uint32[S], sums to 2^n
    F: np.ndarray          # uint32[S+1]
    params: RansParams

    @classmethod
    def from_counts(cls, counts: np.ndarray, params: RansParams) -> "StaticModel":
        f = quantize_pdf(counts, params.n_bits)
        return cls(f=f, F=build_cdf(f), params=params)

    @classmethod
    def from_symbols(cls, symbols: np.ndarray, alphabet_size: int,
                     params: RansParams) -> "StaticModel":
        counts = np.bincount(np.asarray(symbols).ravel(), minlength=alphabet_size)
        return cls.from_counts(counts, params)

    @property
    def alphabet_size(self) -> int:
        return len(self.f)

    def slot_lut(self) -> np.ndarray:
        return build_slot_lut(self.f, self.F)

    def table_bytes(self) -> int:
        """Serialized size of the distribution table (counts as file overhead
        for *every* variation equally, so comparisons are unaffected)."""
        # f entries, n_bits each, bit-packed.
        return (len(self.f) * self.params.n_bits + 7) // 8


def encode_scalar(symbols: np.ndarray, model: StaticModel,
                  log_emissions: bool = False):
    """Sequential single-way rANS encoder (paper Eq. 1 + Eq. 3). Oracle only.

    Returns (stream_u16, final_state) and, if requested, the emission log
    (k[q], y[q]) where k is the symbol index about to be encoded when word q
    was emitted and y the bounded post-renorm state (Lemma 3.1: y < L).
    """
    p = model.params
    f, F = model.f, model.F
    x = np.uint64(p.lower_bound)
    stream, ks, ys = [], [], []
    for k, s in enumerate(np.asarray(symbols, dtype=np.int64)):
        fs = np.uint64(f[s])
        if (x >> np.uint64(p.renorm_shift)) >= fs:
            stream.append(int(x) & p.word_mask)
            x >>= np.uint64(p.b_bits)
            assert x < p.lower_bound, "Lemma 3.1 violated"
            if log_emissions:
                ks.append(k)
                ys.append(int(x))
        x = (x // fs) * np.uint64(p.scale) + np.uint64(F[s]) + x % fs
    out = np.asarray(stream, dtype=np.uint16)
    if log_emissions:
        return out, np.uint32(x), np.asarray(ks, np.int64), np.asarray(ys, np.uint32)
    return out, np.uint32(x)


def decode_scalar(stream: np.ndarray, final_state: np.uint32, n_symbols: int,
                  model: StaticModel) -> np.ndarray:
    """Sequential single-way rANS decoder (paper Eq. 2 + Eq. 4). Oracle only."""
    p = model.params
    f, F = model.f, model.F
    lut = model.slot_lut()
    x = np.uint64(final_state)
    pos = len(stream)
    out = np.zeros(n_symbols, dtype=np.int64)
    for k in range(n_symbols - 1, -1, -1):
        slot = int(x) & p.slot_mask
        s = int(lut[slot])
        out[k] = s
        x = np.uint64(f[s]) * (x >> np.uint64(p.n_bits)) + np.uint64(slot - int(F[s]))
        if x < p.lower_bound:
            pos -= 1
            x = (x << np.uint64(p.b_bits)) | np.uint64(stream[pos])
    if pos != 0:
        raise ValueError(f"stream not fully consumed: {pos} words left")
    return out
