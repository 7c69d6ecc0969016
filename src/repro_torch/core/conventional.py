"""Conventional "partitioning symbols" baseline (paper §2.3, DietGPU-style).

The input symbol sequence is split into P contiguous sub-sequences *before*
encoding; each is encoded by an independent W-way interleaved rANS coder.
Parallelism is therefore fixed at encode time and every client downloads the
full per-partition overhead (final states + directory), which is the problem
Recoil solves.  Implemented with the same building blocks as Recoil (paper
§5.1 does the same to keep the comparison about the algorithms).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .interleaved import EncodedStream, SplitState, encode_interleaved, walk_decode_split
from .rans import StaticModel


@dataclasses.dataclass(frozen=True)
class ConventionalEncoded:
    partitions: tuple[EncodedStream, ...]
    n_symbols: int

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    def stream_bytes(self) -> int:
        return sum(p.stream_bytes() for p in self.partitions)

    def overhead_bytes(self) -> int:
        """Per-partition setup cost: directory entry (word count u32 +
        symbol count u32) + W final states (u32 each)."""
        W = self.partitions[0].params.ways if self.partitions else 0
        return self.n_partitions * (4 + 4 + W * 4)

    def concatenated(self) -> tuple[np.ndarray, np.ndarray]:
        """(all words concatenated, partition word offsets[P+1])."""
        offs = np.zeros(self.n_partitions + 1, dtype=np.int64)
        np.cumsum([p.n_words for p in self.partitions], out=offs[1:])
        words = (np.concatenate([p.stream for p in self.partitions])
                 if self.partitions else np.zeros(0, np.uint16))
        return words, offs


def partition_bounds(n_symbols: int, n_partitions: int) -> np.ndarray:
    """Near-equal contiguous chunk boundaries, int64[P+1]."""
    base, rem = divmod(n_symbols, n_partitions)
    sizes = np.full(n_partitions, base, dtype=np.int64)
    sizes[:rem] += 1
    out = np.zeros(n_partitions + 1, dtype=np.int64)
    np.cumsum(sizes, out=out[1:])
    return out


def encode_conventional(symbols: np.ndarray, model: StaticModel,
                        n_partitions: int) -> ConventionalEncoded:
    symbols = np.asarray(symbols).ravel()
    bounds = partition_bounds(len(symbols), n_partitions)
    parts = tuple(encode_interleaved(symbols[bounds[p]:bounds[p + 1]], model)
                  for p in range(n_partitions))
    return ConventionalEncoded(partitions=parts, n_symbols=len(symbols))


def decode_conventional(conv: ConventionalEncoded, model: StaticModel) -> np.ndarray:
    """Oracle decode — partitions are fully independent (parallel semantics)."""
    from .interleaved import decode_interleaved
    return np.concatenate([decode_interleaved(p, model) for p in conv.partitions])


def to_split_states(conv: ConventionalEncoded) -> tuple[list[SplitState], np.ndarray, np.ndarray]:
    """Adapter: express each partition as a final-thread-style SplitState over
    the concatenated stream, so the vectorized/CUDA walk decoder runs the
    Conventional baseline too (out_bases maps local kept ranges to global)."""
    words, offs = conv.concatenated()
    states = []
    for p, part in enumerate(conv.partitions):
        W = part.params.ways
        N = part.n_symbols
        sentinel = np.arange(W, dtype=np.int64) + N + W
        sentinel = sentinel - (sentinel % W) + np.arange(W)
        states.append(SplitState(
            k=sentinel, y=np.zeros(W, dtype=np.uint32),
            x0=part.final_states, q0=int(offs[p + 1]) - 1,
            start=N - 1, stop=0, keep_lo=0, keep_hi=N))
    out_bases = np.zeros(conv.n_partitions, dtype=np.int64)
    np.cumsum([pt.n_symbols for pt in conv.partitions[:-1]], out=out_bases[1:])
    return states, words, out_bases


def decode_conventional_walk(conv: ConventionalEncoded, model: StaticModel) -> np.ndarray:
    """Decode via the shared walk machinery (covers the adapter path)."""
    states, words, out_bases = to_split_states(conv)
    out = np.full(conv.n_symbols, -1, dtype=np.int64)
    for st, base, part in zip(states, out_bases, conv.partitions):
        local = np.full(part.n_symbols, -1, dtype=np.int64)
        walk_decode_split(st, words, model, local)
        out[base:base + part.n_symbols] = local
    assert (out >= 0).all()
    return out
