"""On-wire container formats for every paper variation (a)-(e).

These are the byte layouts the benchmarks measure (paper Tables 4-6) and the
content-delivery example serves.  All variations share the distribution-table
encoding so comparisons isolate the parallelism overhead:

  (a) SINGLE        one interleaved stream + W final states (baseline)
  (b)/(d) CONV      P independent streams + directory + P*W final states
  (c)/(e) RECOIL    the (a) payload + a §4.3 metadata blob (combinable)

Layout primitives are little-endian; sections are length-prefixed so readers
can skip unknown trailing sections (forward compatibility).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from . import metadata as md
from .conventional import ConventionalEncoded
from .interleaved import EncodedStream
from .rans import RansParams, StaticModel, build_cdf
from .recoil import RecoilPlan

MAGIC = b"RCL1"
KIND_SINGLE, KIND_CONV, KIND_RECOIL = 0, 1, 2
KIND_RECOIL_CHUNKED = 3


def _pack_table(model: StaticModel) -> bytes:
    """Distribution table: alphabet size + n_bits-wide quantized frequencies."""
    from .bitio import BitWriter
    w = BitWriter()
    w.write(model.alphabet_size, 24)
    w.write(model.params.n_bits, 8)
    w.write_array(model.f.astype(np.int64), model.params.n_bits)
    body = w.getvalue()
    return struct.pack("<I", len(body)) + body


def _unpack_table(buf: bytes, off: int, params: RansParams) -> tuple[StaticModel, int]:
    from .bitio import BitReader
    (ln,) = struct.unpack_from("<I", buf, off)
    off += 4
    r = BitReader(buf[off:off + ln])
    alpha = r.read(24)
    n_bits = r.read(8)
    if n_bits != params.n_bits:
        raise ValueError("container quantization level mismatch")
    f = r.read_array(alpha, n_bits).astype(np.uint32)
    model = StaticModel(f=f, F=build_cdf(f), params=params)
    return model, off + ln


@dataclasses.dataclass(frozen=True)
class SizeBreakdown:
    header: int
    table: int
    finals: int
    stream: int
    directory: int     # conventional partition directory
    split_metadata: int  # recoil §4.3 blob

    @property
    def total(self) -> int:
        return (self.header + self.table + self.finals + self.stream
                + self.directory + self.split_metadata)

    @property
    def overhead(self) -> int:
        """Everything that is not entropy-coded payload."""
        return self.total - self.stream - self.table


def pack_single(enc: EncodedStream, model: StaticModel) -> bytes:
    head = MAGIC + struct.pack("<BBHQQ", KIND_SINGLE, model.params.n_bits,
                               model.params.ways, enc.n_symbols, enc.n_words)
    return (head + _pack_table(model)
            + enc.final_states.astype("<u4").tobytes()
            + enc.stream.astype("<u2").tobytes())


def pack_recoil(enc: EncodedStream, model: StaticModel, plan: RecoilPlan) -> bytes:
    head = MAGIC + struct.pack("<BBHQQ", KIND_RECOIL, model.params.n_bits,
                               model.params.ways, enc.n_symbols, enc.n_words)
    blob = md.serialize_plan(plan)
    return (head + _pack_table(model)
            + enc.final_states.astype("<u4").tobytes()
            + struct.pack("<I", len(blob)) + blob
            + enc.stream.astype("<u2").tobytes())


def pack_recoil_chunked(enc: EncodedStream, model: StaticModel,
                        plan: RecoilPlan, n_chunks: int) -> bytes:
    """KIND_RECOIL_CHUNKED: the RECOIL payload plus a chunk directory for
    streaming decode (DESIGN.md §10).

    The stream bytes are IDENTICAL to ``pack_recoil``'s — chunking adds a
    directory of cumulative prefixes, never reorders the payload.  Chunk
    boundaries partition the plan's split rows (``engine.plan.chunk_bounds``
    — the same partition the serving plans use); per chunk ``c`` the
    directory carries

        sym_end[c]    — symbols decoded once chunks ``<= c`` complete,
        words_end[c]  — the stream-word prefix chunk ``c``'s rows read
                        (monotone: each chunk is decodable as soon as its
                        prefix has arrived — time-to-first-symbol is
                        O(chunk), not O(asset)),
        split_end[c]  — split rows consumed, so a receiver reconstructs
                        each chunk's WalkBatch from the one plan blob.

    Layout: RECOIL head (kind=3) + table + finals + plan blob +
    ``<I`` chunk count + ``<III`` per chunk + stream words.
    """
    from .engine.plan import chunk_bounds
    n_rows = plan.n_threads
    bounds = chunk_bounds(n_rows, n_chunks)
    comps = [p.completion for p in plan.points] + [plan.n_symbols]
    q0s = [p.offset for p in plan.points] + [plan.n_words - 1]
    directory = struct.pack("<I", len(bounds))
    for r0, r1 in bounds:
        sym_end = comps[r1 - 1]
        words_end = max(q0s[r0:r1]) + 1
        directory += struct.pack("<III", sym_end, words_end, r1)
    head = MAGIC + struct.pack("<BBHQQ", KIND_RECOIL_CHUNKED,
                               model.params.n_bits, model.params.ways,
                               enc.n_symbols, enc.n_words)
    blob = md.serialize_plan(plan)
    return (head + _pack_table(model)
            + enc.final_states.astype("<u4").tobytes()
            + struct.pack("<I", len(blob)) + blob
            + directory
            + enc.stream.astype("<u2").tobytes())


@dataclasses.dataclass(frozen=True)
class ChunkDirectory:
    """Cumulative per-chunk prefixes of a KIND_RECOIL_CHUNKED container."""

    sym_end: np.ndarray     # int64[C]
    words_end: np.ndarray   # int64[C]
    split_end: np.ndarray   # int64[C]

    @property
    def n_chunks(self) -> int:
        return len(self.sym_end)

    def ready(self, words_arrived: int) -> int:
        """How many leading chunks are decodable given an arrived stream
        prefix of ``words_arrived`` words (the streaming-receiver test)."""
        return int(np.searchsorted(self.words_end, words_arrived,
                                   side="right"))


def pack_conventional(conv: ConventionalEncoded, model: StaticModel) -> bytes:
    p0 = conv.partitions[0].params
    head = MAGIC + struct.pack("<BBHQQ", KIND_CONV, model.params.n_bits,
                               p0.ways, conv.n_symbols, len(conv.partitions))
    directory = b"".join(
        struct.pack("<II", part.n_words, part.n_symbols)
        for part in conv.partitions)
    finals = b"".join(part.final_states.astype("<u4").tobytes()
                      for part in conv.partitions)
    streams = b"".join(part.stream.astype("<u2").tobytes()
                       for part in conv.partitions)
    return head + _pack_table(model) + directory + finals + streams


def size_breakdown(enc=None, model=None, plan=None, conv=None) -> SizeBreakdown:
    """Byte accounting per component (matches the pack_* layouts exactly)."""
    header = len(MAGIC) + struct.calcsize("<BBHQQ")
    table = len(_pack_table(model))
    if conv is not None:
        W = conv.partitions[0].params.ways
        return SizeBreakdown(header=header, table=table,
                             finals=conv.n_partitions * W * 4,
                             stream=conv.stream_bytes(),
                             directory=conv.n_partitions * 8,
                             split_metadata=0)
    finals = enc.params.ways * 4
    blob = 4 + len(md.serialize_plan(plan)) if plan is not None else 0
    return SizeBreakdown(header=header, table=table, finals=finals,
                         stream=enc.stream_bytes(), directory=0,
                         split_metadata=blob)


@dataclasses.dataclass(frozen=True)
class ParsedContainer:
    kind: int
    model: StaticModel
    n_symbols: int
    stream: np.ndarray | None = None          # single / recoil
    final_states: np.ndarray | None = None
    plan: RecoilPlan | None = None            # recoil
    conv_n_words: np.ndarray | None = None    # conventional
    conv_n_syms: np.ndarray | None = None
    conv_finals: np.ndarray | None = None     # (P, W) u32
    conv_streams: list | None = None
    chunks: ChunkDirectory | None = None      # recoil-chunked


def parse(buf: bytes, params: RansParams) -> ParsedContainer:
    if buf[:4] != MAGIC:
        raise ValueError("bad magic")
    kind, n_bits, ways, a, b = struct.unpack_from("<BBHQQ", buf, 4)
    off = 4 + struct.calcsize("<BBHQQ")
    if n_bits != params.n_bits or ways != params.ways:
        raise ValueError("container/params mismatch")
    model, off = _unpack_table(buf, off, params)
    if kind in (KIND_SINGLE, KIND_RECOIL, KIND_RECOIL_CHUNKED):
        n_symbols, n_words = a, b
        finals = np.frombuffer(buf, "<u4", ways, off).copy()
        off += ways * 4
        plan = None
        chunks = None
        if kind in (KIND_RECOIL, KIND_RECOIL_CHUNKED):
            (ln,) = struct.unpack_from("<I", buf, off)
            off += 4
            plan = md.deserialize_plan(buf[off:off + ln])
            off += ln
        if kind == KIND_RECOIL_CHUNKED:
            (n_chunks,) = struct.unpack_from("<I", buf, off)
            off += 4
            d = np.frombuffer(buf, "<u4", 3 * n_chunks, off).reshape(-1, 3)
            off += 12 * n_chunks
            chunks = ChunkDirectory(sym_end=d[:, 0].astype(np.int64),
                                    words_end=d[:, 1].astype(np.int64),
                                    split_end=d[:, 2].astype(np.int64))
        stream = np.frombuffer(buf, "<u2", n_words, off).copy()
        return ParsedContainer(kind=kind, model=model, n_symbols=n_symbols,
                               stream=stream, final_states=finals, plan=plan,
                               chunks=chunks)
    n_symbols, P = a, b
    dirty = np.frombuffer(buf, "<u4", 2 * P, off).reshape(P, 2)
    off += 8 * P
    finals = np.frombuffer(buf, "<u4", P * ways, off).reshape(P, ways).copy()
    off += 4 * P * ways
    streams = []
    for p in range(P):
        nw = int(dirty[p, 0])
        streams.append(np.frombuffer(buf, "<u2", nw, off).copy())
        off += 2 * nw
    return ParsedContainer(kind=kind, model=model, n_symbols=n_symbols,
                           conv_n_words=dirty[:, 0].astype(np.int64),
                           conv_n_syms=dirty[:, 1].astype(np.int64),
                           conv_finals=finals, conv_streams=streams)
