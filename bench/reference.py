"""The plain reference that decides ``correct``: plain numpy and torch.

It imports nothing of the program and takes nothing the program made
except the outputs it judges.  Two parts:

- ``parse_container``: a reader of the Recoil wire container (paper §4.3
  metadata: header, Table 1 series, per entry W 16-bit bounded states and a
  series of group-id differences, MSB first), written from the format's
  description.
- ``walk``: rANS decoding of interleaved streams from their split metadata
  (paper §3-4, Figure 1), vectorized over every split of every content and
  every way, one symbol group a step.  From the decoded symbols and the
  words each split consumed it judges a stream: the kept ranges decode to
  the content, the first split ends at the encoder's initial state L with
  every word below its anchor consumed, the splits' word ranges cover the
  stream, and where two splits meet, the later split's last state of each
  way equals the state the earlier split holds at that symbol.  A stream
  that passes decodes as one serial decode would, so it is the canonical
  encoding of the content.  The reference cannot afford to re-encode a
  10 MB content (a chain of 312,500 dependent group steps), so it follows
  the split states the stream carries and checks the start and each
  junction between splits by themselves.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

MAGIC = b"RCL1"
KIND_RECOIL = 2
L_BITS = B_BITS = 16
LOWER = 1 << L_BITS


@dataclasses.dataclass
class Container:
    n_bits: int
    ways: int
    n_symbols: int
    n_words: int
    freqs: np.ndarray          # int64[A]
    finals: np.ndarray         # int64[W]
    n_threads: int             # the metadata's thread count M
    offsets: np.ndarray        # int64[M-1]
    ks: np.ndarray             # int64[M-1, W]
    ys: np.ndarray             # int64[M-1, W]
    words: np.ndarray          # uint16[n_words]
    table_bytes: int           # serialized table, length field included
    metadata_bytes: int        # serialized split metadata, length included
    size: int                  # the whole container


class _Bits:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0

    def take(self, count: int, width: int) -> np.ndarray:
        if width == 0:
            return np.zeros(count, np.int64)
        end = self.pos + count * width
        if end > self.bits.size:
            raise ValueError("metadata ends early")
        b = self.bits[self.pos:end].reshape(count, width).astype(np.int64)
        self.pos = end
        return b @ (np.int64(1) << np.arange(width - 1, -1, -1,
                                             dtype=np.int64))

    def one(self, width: int) -> int:
        return int(self.take(1, width)[0])

    def series(self, count: int, field: int, signed: bool) -> np.ndarray:
        v = self.take(count, self.one(field) + 1)
        return (v >> 1) ^ -(v & 1) if signed else v


def parse_container(buf: bytes) -> Container:
    """Read a KIND_RECOIL container; raises ValueError if it is malformed."""
    if buf[:4] != MAGIC:
        raise ValueError("bad magic")
    kind, n_bits, ways, n_symbols, n_words = struct.unpack_from(
        "<BBHQQ", buf, 4)
    if kind != KIND_RECOIL:
        raise ValueError(f"kind {kind} is not a Recoil container")
    off = 4 + struct.calcsize("<BBHQQ")
    (ln,) = struct.unpack_from("<I", buf, off)
    table = _Bits(buf[off + 4:off + 4 + ln])
    alphabet, tb = table.one(24), table.one(8)
    if tb != n_bits:
        raise ValueError("table and header disagree on n")
    freqs = table.take(alphabet, n_bits)
    table_bytes = 4 + ln
    off += table_bytes
    finals = np.frombuffer(buf, "<u4", ways, off).astype(np.int64)
    off += 4 * ways
    (ln,) = struct.unpack_from("<I", buf, off)
    md = _Bits(buf[off + 4:off + 4 + ln])
    metadata_bytes = 4 + ln
    off += metadata_bytes
    M, mw, mn, mways, _ = (md.one(32), md.one(40), md.one(40), md.one(12),
                           md.one(4))
    if (mw, mn, mways) != (n_words, n_symbols, ways):
        raise ValueError("metadata and header disagree")
    E = M - 1
    offsets = np.zeros(0, np.int64)
    ks = np.zeros((0, ways), np.int64)
    ys = np.zeros((0, ways), np.int64)
    if E > 0:
        i1 = np.arange(1, E + 1, dtype=np.int64)
        per_words = -(-n_words // M)
        per_groups = -(-(-(-n_symbols // ways)) // M)
        offsets = md.series(E, 6, True) + i1 * per_words
        gmax = md.series(E, 6, True) + i1 * per_groups
        ks = np.empty((E, ways), np.int64)
        ys = np.empty((E, ways), np.int64)
        lanes = np.arange(ways, dtype=np.int64)
        for e in range(E):
            ys[e] = md.take(ways, 16)
            ks[e] = (gmax[e] - md.series(ways, 4, False)) * ways + lanes
    words = np.frombuffer(buf, "<u2", n_words, off)
    if off + 2 * n_words != len(buf):
        raise ValueError("container length disagrees with its stream")
    return Container(n_bits=n_bits, ways=ways, n_symbols=n_symbols,
                     n_words=n_words, freqs=freqs, finals=finals,
                     n_threads=M, offsets=offsets, ks=ks, ys=ys, words=words,
                     table_bytes=table_bytes, metadata_bytes=metadata_bytes,
                     size=len(buf))


@dataclasses.dataclass
class Stream:
    """One content's stream as the reference walks it: words (any integer
    dtype holding the u16 values or their int16 bit patterns), final
    states, split points and the symbol count."""
    words: torch.Tensor
    finals: np.ndarray
    offsets: np.ndarray
    ks: np.ndarray
    ys: np.ndarray
    n_symbols: int


@dataclasses.dataclass
class Verdict:
    symbols: torch.Tensor      # int64, decoded content of every stream
    bad_ends: int              # splits failing the start, covering or
                               # read-range conditions, and split metadata
                               # that breaks its invariants


def _splits(s: Stream, ways: int):
    """Per split (symbol order): k, y, x0, q0, start, stop, keep_lo,
    keep_hi, and the number of metadata invariants broken."""
    E = len(s.offsets)
    N = s.n_symbols
    lanes = np.arange(ways, dtype=np.int64)
    bad = 0
    if E:
        comps = s.ks.min(axis=1)
        bad += int(np.any(s.ks % ways != lanes))
        bad += int(np.any(s.ys >= LOWER) or np.any(s.ys < 0))
        bad += int(np.any(np.diff(s.offsets) <= 0)
                   or np.any(np.diff(comps) <= 0) or comps[0] <= 0
                   or s.offsets[0] < 0)
    sentinel = (N + ways) // ways * ways + ways + lanes
    k = np.concatenate([s.ks, sentinel[None]]) if E else sentinel[None]
    y = np.concatenate([s.ys, np.zeros((1, ways), np.int64)])
    x0 = np.zeros((E + 1, ways), np.int64)
    x0[E] = s.finals
    q0 = np.append(s.offsets, len(s.words) - 1)
    comps = np.append(k[:E].min(axis=1), N) if E else np.array([N])
    keep_lo = np.concatenate([[0], comps[:-1]])
    start = np.append(k[:E].max(axis=1), N - 1) if E else np.array([N - 1])
    return k, y, x0, q0, start, keep_lo, keep_lo.copy(), comps, bad


def walk(streams: list[Stream], freqs: np.ndarray, n_bits: int, ways: int,
         device) -> Verdict:
    """Decode every stream from its split metadata (all splits of all
    streams in one vectorized walk) and judge the streams' ends."""
    dev = torch.device(device)
    f = torch.as_tensor(np.asarray(freqs, np.int64), device=dev)
    F = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                   torch.cumsum(f, 0)])
    scale = 1 << n_bits
    lut = torch.repeat_interleave(torch.arange(len(f), device=dev), f)
    if int(F[-1]) != scale:
        raise ValueError("frequencies do not sum to 2^n")
    parts = {n: [] for n in ("k", "y", "x0", "q0", "start", "stop",
                             "lo", "hi", "wbase", "wend", "obase")}
    bad = 0
    word_parts, w_at, o_at, first = [], 0, 0, []
    for s in streams:
        k, y, x0, q0, start, stop, lo, hi, b = _splits(s, ways)
        bad += b
        first.append(sum(len(v) for v in parts["q0"]))
        for n, v in (("k", k), ("y", y), ("x0", x0), ("q0", q0),
                     ("start", start), ("stop", stop), ("lo", lo),
                     ("hi", hi)):
            parts[n].append(v)
        S = len(q0)
        parts["wbase"].append(np.full(S, w_at))
        parts["wend"].append(np.full(S, w_at + len(s.words)))
        parts["obase"].append(np.full(S, o_at))
        word_parts.append(s.words.to(dev).long() & 0xFFFF)
        w_at += len(s.words)
        o_at += s.n_symbols
    cat = {n: torch.as_tensor(np.concatenate(v), device=dev)
           for n, v in parts.items()}
    words = torch.cat(word_parts)
    k, y, x, q = cat["k"], cat["y"], cat["x0"].clone(), cat["q0"].clone()
    start, stop, lo, hi = cat["start"], cat["stop"], cat["lo"], cat["hi"]
    wbase, wend, obase = cat["wbase"], cat["wend"], cat["obase"]
    # One slot past the end takes the writes of lanes that keep nothing,
    # so the scatter needs no host sync.
    out = torch.full((o_at + 1,), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(ways, device=dev)
    g_hi = torch.div(start, ways, rounding_mode="floor")
    g_lo = torch.div(stop, ways, rounding_mode="floor")
    misread = torch.zeros(len(q), dtype=torch.bool, device=dev)
    # Where the next split's walk ends in each way: the lowest index of the
    # way at or above this split's completion; the state there is recorded.
    comp = k.min(1).values
    meet = comp[:, None] + torch.remainder(lanes - comp[:, None], ways)
    snap = torch.zeros_like(x)
    steps = int((g_hi - g_lo).max()) + 1 if len(q) else 0
    for t in range(steps):
        i = (g_hi - t)[:, None] * ways + lanes
        live = (i <= start[:, None]) & (i >= stop[:, None])
        recon = live & (i == k)
        dec = live & (i < k)
        slot = x & (scale - 1)
        sym = lut[slot]
        xd = f[sym] * (x >> n_bits) + slot - F[sym]
        under = dec & (xd < LOWER)
        take = (recon | under).long()
        ahead = take.flip(1).cumsum(1).flip(1) - take
        widx = (wbase + q)[:, None] - ahead
        misread |= ((take > 0) & ((widx < wbase[:, None])
                                  | (widx >= wend[:, None]))).any(1)
        word = words[widx.clamp(0, len(words) - 1)]
        x = torch.where(recon, (y << B_BITS) | word,
                        torch.where(under, (xd << B_BITS) | word,
                                    torch.where(dec, xd, x)))
        snap = torch.where(live & (i == meet), x, snap)
        keep = dec & (i >= lo[:, None]) & (i < hi[:, None])
        out.scatter_(0, torch.where(keep, obase[:, None] + i, o_at).view(-1),
                     sym.view(-1))
        q = q - take.sum(1)
    # Ends: the first split of each stream leaves every way at L with the
    # words below its anchor consumed; consecutive splits' word ranges
    # [q_end + 1, q0] touch or overlap and meet in the same states; no read
    # outside the stream.
    ends = misread.clone()
    first_t = torch.as_tensor(first, device=dev)
    n_live = torch.as_tensor([min(ways, s.n_symbols) for s in streams],
                             device=dev)
    at_l = torch.where(lanes[None] < n_live[:, None], x[first_t] == LOWER,
                       torch.ones_like(x[first_t], dtype=torch.bool))
    ends[first_t] |= ~at_l.all(1) | (q[first_t] != -1)
    low = q + 1
    nxt = torch.arange(1, len(q), device=dev)
    same = obase[nxt] == obase[nxt - 1]
    ends[nxt] |= same & ((low[nxt] > cat["q0"][nxt - 1] + 1)
                         | (x[nxt] != snap[nxt - 1]).any(1))
    return Verdict(symbols=out[:o_at], bad_ends=bad + int(ends.sum()))


def wrong_symbols(got: torch.Tensor, want: torch.Tensor) -> int:
    """Symbols of ``got`` that differ from ``want`` (the content), with
    every missing or surplus symbol counted as wrong."""
    n = min(got.numel(), want.numel())
    diff = int((got[:n].long() != want[:n].long().to(got.device)).sum())
    return diff + abs(got.numel() - want.numel())
