"""Adaptive (symbol-index-keyed) coding — paper §3.1 advantage (3) and the
div2k hyperprior experiments (§5.1-5.2).

Learned-image codecs (mbt2018-mean etc.) model each latent symbol with its own
Gaussian, parameterized by a hyperprior.  Practical entropy-coder stacks
quantize the per-symbol scale onto a small table of pre-built distributions
(scale bins) — the symbol *index* then keys which distribution to use.  Recoil
records the symbol index at each split exactly so this works in parallel
decoding (paper §3.1, advantage 3).

We reproduce that structure: ``ContextModel`` holds C quantized distributions
over a shared alphabet + an index->context map.  Encode/decode mirror the
static paths with one extra gather on the context axis.  The Recoil split
machinery (planning, metadata, combining) is identical — it never looks at
the distributions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .interleaved import EncodedStream, SplitState
from .rans import RansParams, build_cdf, quantize_pdf


def gaussian_counts(mean: float, scale: float, alphabet: int) -> np.ndarray:
    """Discretized-Gaussian pseudo-counts over [0, alphabet) (balle-style)."""
    xs = np.arange(alphabet, dtype=np.float64)
    z = (xs - mean) / max(scale, 1e-3)
    pdf = np.exp(-0.5 * z * z)
    pdf += 1e-12
    return pdf


def laplacian_counts(mean: float, scale: float, alphabet: int) -> np.ndarray:
    xs = np.arange(alphabet, dtype=np.float64)
    pdf = np.exp(-np.abs(xs - mean) / max(scale, 1e-3))
    pdf += 1e-12
    return pdf


@dataclasses.dataclass(frozen=True)
class ContextModel:
    """C quantized distributions over one alphabet + per-symbol context ids."""

    f: np.ndarray        # uint32[C, A] — each row sums to 2^n
    F: np.ndarray        # uint32[C, A+1]
    ctx: np.ndarray      # int32[N] — context id per symbol index
    params: RansParams

    @classmethod
    def from_scale_table(cls, scales: np.ndarray, ctx: np.ndarray,
                         alphabet: int, params: RansParams,
                         family: str = "gaussian",
                         mean: float | None = None) -> "ContextModel":
        mean = alphabet / 2 if mean is None else mean
        fam = gaussian_counts if family == "gaussian" else laplacian_counts
        rows = [quantize_pdf(fam(mean, s, alphabet), params.n_bits)
                for s in np.asarray(scales, dtype=np.float64)]
        f = np.stack(rows).astype(np.uint32)
        F = np.stack([build_cdf(r) for r in rows]).astype(np.uint32)
        return cls(f=f, F=F, ctx=np.asarray(ctx, dtype=np.int32), params=params)

    @property
    def n_contexts(self) -> int:
        return self.f.shape[0]

    @property
    def alphabet_size(self) -> int:
        return self.f.shape[1]

    def slot_luts(self) -> np.ndarray:
        """int32[C, 2^n] slot->symbol tables."""
        scale = self.params.scale
        luts = np.zeros((self.n_contexts, scale), dtype=np.int32)
        for c in range(self.n_contexts):
            luts[c] = np.repeat(np.arange(self.alphabet_size, dtype=np.int32),
                                np.diff(self.F[c].astype(np.int64)))
        return luts

    def table_bytes(self) -> int:
        return (self.f.size * self.params.n_bits + 7) // 8


def encode_interleaved_adaptive(symbols: np.ndarray, model: ContextModel) -> EncodedStream:
    """W-way interleaved encoder with per-index distributions + emission log."""
    p = model.params
    W = p.ways
    syms = np.asarray(symbols, dtype=np.int64).ravel()
    if len(syms) != len(model.ctx):
        raise ValueError("ctx map must cover every symbol index")
    f_tab = model.f.astype(np.int64)
    F_tab = model.F.astype(np.int64)
    x = [p.lower_bound] * W
    stream, ks, ys = [], [], []
    shift = p.renorm_shift
    for i, s in enumerate(syms):
        j = i % W
        c = int(model.ctx[i])
        fs = int(f_tab[c, s])
        if fs == 0:
            raise ValueError(f"symbol {s} has zero frequency in context {c}")
        xi = x[j]
        if (xi >> shift) >= fs:
            stream.append(xi & p.word_mask)
            xi >>= p.b_bits
            ks.append(i)
            ys.append(xi)
        x[j] = ((xi // fs) << p.n_bits) + int(F_tab[c, s]) + (xi % fs)
    return EncodedStream(
        stream=np.asarray(stream, dtype=np.uint16),
        final_states=np.asarray(x, dtype=np.uint32),
        n_symbols=len(syms), params=p,
        k_of_word=np.asarray(ks, dtype=np.int64),
        y_of_word=np.asarray(ys, dtype=np.uint32))


def walk_decode_split_adaptive(split: SplitState, stream: np.ndarray,
                               model: ContextModel, out: np.ndarray) -> int:
    """Adaptive-coding walk: distribution keyed by symbol index (ctx map).

    This is why Recoil metadata stores symbol indices — each thread knows the
    absolute index of every symbol it touches.
    """
    p = model.params
    W = p.ways
    f_tab = model.f.astype(np.int64)
    F_tab = model.F.astype(np.int64)
    luts = model.slot_luts()
    x = [int(v) for v in split.x0]
    k = split.k
    q = split.q0
    for i in range(split.start, split.stop - 1, -1):
        j = i % W
        if i == k[j]:
            x[j] = (int(split.y[j]) << p.b_bits) | int(stream[q])
            q -= 1
        elif i < k[j]:
            c = int(model.ctx[i])
            xi = x[j]
            slot = xi & p.slot_mask
            s = int(luts[c, slot])
            if split.keep_lo <= i < split.keep_hi:
                out[i] = s
            xi = int(f_tab[c, s]) * (xi >> p.n_bits) + slot - int(F_tab[c, s])
            if xi < p.lower_bound:
                xi = (xi << p.b_bits) | int(stream[q])
                q -= 1
            x[j] = xi
    return split.q0 - q


def decode_recoil_adaptive(plan, stream, final_states, model: ContextModel) -> np.ndarray:
    from .recoil import build_split_states
    out = np.full(plan.n_symbols, -1, dtype=np.int64)
    for split in build_split_states(plan, final_states):
        walk_decode_split_adaptive(split, stream, model, out)
    assert (out >= 0).all()
    return out
