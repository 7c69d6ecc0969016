"""W-way interleaved rANS (paper §2.2, Giesen [9]) — host-side oracle codecs.

Semantics (paper Figure 1):
  * symbol ``s_i`` is handled by way ``j = i mod W``;
  * encoding walks ``i = 0..N-1``; before encoding ``s_i`` way ``j`` renormalizes
    (emits the low ``b`` bits once — ``b >= n`` guarantees a single step) if the
    encode transform would overflow; emitted words from one group of W symbols
    land in the stream in increasing way order, i.e. plain stream order;
  * decoding walks ``i = N-1..0``; way ``j`` decodes ``s_i`` from its state and
    then renorm-reads one word from the stream tail if it underflows ``L``.
    Words are therefore consumed in exactly reverse emission order.

Emission log (the Recoil substrate, §3.1/§4.1): each emitted word ``q`` is
annotated with ``k_of_word[q]`` — the symbol index about to be encoded when the
word was emitted — and ``y_of_word[q]`` — the post-renorm (bounded, Lemma 3.1:
``y < L``) state of that way.  During decoding, the word at ``q`` is consumed by
the renorm-read that follows the decode of ``s_{k_of_word[q]}``, and

    x_restored = (y_of_word[q] << b) | stream[q]

is exactly the state way ``j`` needs to decode symbol ``k_of_word[q] - W``.
The emission index IS the stream offset, so the log is parallel to the stream.

These oracles are pure-python-int (no overflow traps) and intentionally simple;
the fast paths live in :mod:`repro_torch.core.vectorized` (torch step loops
over symbol groups) and :mod:`repro_torch.kernels.rans_decode` (CUDA).  Every
fast path is tested against these.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .rans import RansParams, StaticModel


@dataclasses.dataclass(frozen=True)
class EncodedStream:
    """A single interleaved rANS bitstream plus the Recoil emission log."""

    stream: np.ndarray        # uint16[Nw] — renormalization words, emission order
    final_states: np.ndarray  # uint32[W]  — transmitted with every variation
    n_symbols: int
    params: RansParams
    # Emission log, parallel to ``stream`` (offset q == array index):
    k_of_word: np.ndarray     # int64[Nw]  — symbol index at emission
    y_of_word: np.ndarray     # uint32[Nw] — bounded post-renorm state (< L)

    @property
    def n_words(self) -> int:
        return int(self.stream.shape[0])

    def stream_bytes(self) -> int:
        return self.n_words * 2

    def way_of_word(self) -> np.ndarray:
        return (self.k_of_word % self.params.ways).astype(np.int64)


def encode_interleaved(symbols: np.ndarray, model: StaticModel) -> EncodedStream:
    """Oracle W-way interleaved encoder with emission log (paper Eq. 1+3)."""
    p = model.params
    W = p.ways
    f_tab = model.f.astype(np.int64)
    F_tab = model.F.astype(np.int64)
    syms = np.asarray(symbols, dtype=np.int64).ravel()
    x = [p.lower_bound] * W
    stream: list[int] = []
    ks: list[int] = []
    ys: list[int] = []
    shift = p.renorm_shift
    for i, s in enumerate(syms):
        j = i % W
        fs = int(f_tab[s])
        if fs == 0:
            raise ValueError(f"symbol {s} has zero quantized frequency")
        xi = x[j]
        if (xi >> shift) >= fs:                      # renorm: emit once (b >= n)
            stream.append(xi & p.word_mask)
            xi >>= p.b_bits
            assert xi < p.lower_bound, "Lemma 3.1 violated"
            ks.append(i)
            ys.append(xi)
        x[j] = ((xi // fs) << p.n_bits) + int(F_tab[s]) + (xi % fs)
        assert x[j] < (1 << 32)
    return EncodedStream(
        stream=np.asarray(stream, dtype=np.uint16),
        final_states=np.asarray(x, dtype=np.uint32),
        n_symbols=len(syms),
        params=p,
        k_of_word=np.asarray(ks, dtype=np.int64),
        y_of_word=np.asarray(ys, dtype=np.uint32),
    )


def decode_interleaved(enc: EncodedStream, model: StaticModel) -> np.ndarray:
    """Oracle W-way interleaved full decoder (paper Eq. 2+4, single thread)."""
    p = model.params
    W = p.ways
    f_tab = model.f.astype(np.int64)
    F_tab = model.F.astype(np.int64)
    lut = model.slot_lut()
    x = [int(v) for v in enc.final_states]
    pos = enc.n_words
    out = np.zeros(enc.n_symbols, dtype=np.int64)
    stream = enc.stream
    for i in range(enc.n_symbols - 1, -1, -1):
        j = i % W
        xi = x[j]
        slot = xi & p.slot_mask
        s = int(lut[slot])
        out[i] = s
        xi = int(f_tab[s]) * (xi >> p.n_bits) + slot - int(F_tab[s])
        if xi < p.lower_bound:                       # renorm: read once
            pos -= 1
            xi = (xi << p.b_bits) | int(stream[pos])
        x[j] = xi
    if pos != 0:
        raise ValueError(f"stream not fully consumed: {pos} words left")
    for j in range(min(W, enc.n_symbols), W):
        assert x[j] == p.lower_bound
    return out


# ---------------------------------------------------------------------------
# Recoil split walk (oracle).  See DESIGN.md §1.1 for the derivation.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SplitState:
    """Everything one decoder thread needs to run its walk.

    For metadata-initialized threads, ``x0`` is zero and way ``j`` is
    reconstructed at walk index ``i == k[j]`` as ``(y[j] << b) | stream[Q]``.
    For the final thread (transmitted 32-bit states) ``x0`` holds the states,
    and ``k[j]`` is a sentinel ``> start`` so reconstruction never fires.
    """

    k: np.ndarray          # int64[W] — reconstruction symbol indices (sentinel for final)
    y: np.ndarray          # uint32[W] — bounded states (unused for final thread)
    x0: np.ndarray         # uint32[W] — initial states (zeros unless final thread)
    q0: int                # stream offset of the first word this thread consumes
    start: int             # first (highest) walk symbol index, == max_j k[j] or N-1
    stop: int              # last (lowest) walk symbol index, inclusive (= c_{m-1})
    keep_lo: int           # kept output range [keep_lo, keep_hi)
    keep_hi: int


def walk_decode_split(split: SplitState, stream: np.ndarray,
                      model: StaticModel, out: np.ndarray) -> int:
    """Oracle single-pointer walk for one split; writes kept symbols into
    ``out[keep_lo:keep_hi]`` and returns the number of words consumed.

    Folds the paper's three phases (§4.1.1-4.1.3) into one descending loop:
      * ``i == k[j]``   → Synchronization: reconstruct way j (consumes a word);
      * ``i <  k[j]``   → decode ``s_i``; kept iff ``keep_lo <= i < keep_hi``
                          (indices above ``keep_hi`` are the discarded sync
                          side-effects / this thread's cross-boundary region);
      * ``i >  k[j]``   → way not yet initialized: skip.
    """
    p = model.params
    W = p.ways
    f_tab = model.f.astype(np.int64)
    F_tab = model.F.astype(np.int64)
    lut = model.slot_lut()
    x = [int(v) for v in split.x0]
    k = split.k
    q = split.q0
    for i in range(split.start, split.stop - 1, -1):
        j = i % W
        if i == k[j]:
            x[j] = (int(split.y[j]) << p.b_bits) | int(stream[q])
            q -= 1
        elif i < k[j]:
            xi = x[j]
            slot = xi & p.slot_mask
            s = int(lut[slot])
            if split.keep_lo <= i < split.keep_hi:
                out[i] = s
            xi = int(f_tab[s]) * (xi >> p.n_bits) + slot - int(F_tab[s])
            if xi < p.lower_bound:
                xi = (xi << p.b_bits) | int(stream[q])
                q -= 1
            x[j] = xi
    return split.q0 - q
