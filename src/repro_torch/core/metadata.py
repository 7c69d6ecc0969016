"""Efficient metadata storage (paper §4.3, Tables 1-2).

Everything is stored as *differences from closed-form expectations* so that
near-uniform-entropy data (the common case) codes each split in a few bits
beyond the unavoidable per-way bounded states:

  header:            M (thread count), B (stream words), N (symbols), W, n
  Table-1 series:    per-entry bitstream-offset diff vs  (i+1) * ceil(B/M)
                     per-entry max-group-id  diff vs     (i+1) * ceil(G/M)
                     (two data series over all entries, signed/zigzag,
                      up to 32-bit values -> 6-bit width field)
  Table-2 per entry: W bounded intermediate states, 16 bits as-is
                     W group-id differences vs the entry's max (anchor),
                     one data series per entry (non-negative, up to 16-bit
                     values -> 4-bit width field; zero series still cost
                     1 bit/element, paper footnote 1)

Symbol indices are never stored: ``k[j] = (g_max - d[j]) * W + j`` (Table 2's
"trivial to convert back and forth").
"""

from __future__ import annotations

import numpy as np

from .bitio import BitReader, BitWriter, read_series, write_series
from .recoil import RecoilPlan, SplitPoint

_STATE_BITS = 16
_HDR_FIELDS = (("n_threads", 32), ("n_words", 40), ("n_symbols", 40),
               ("ways", 12), ("reserved", 4))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def serialize_plan(plan: RecoilPlan) -> bytes:
    w = BitWriter()
    M = plan.n_threads
    values = {"n_threads": M, "n_words": plan.n_words,
              "n_symbols": plan.n_symbols, "ways": plan.ways, "reserved": 0}
    for name, bits in _HDR_FIELDS:
        w.write(values[name], bits)
    E = len(plan.points)
    if E == 0:
        return w.getvalue()
    eb = _ceil_div(plan.n_words, M)
    G = _ceil_div(plan.n_symbols, plan.ways)
    eg = _ceil_div(G, M)
    offs = np.asarray([pt.offset for pt in plan.points], dtype=np.int64)
    gmax = np.asarray([int(pt.group_ids(plan.ways).max()) for pt in plan.points],
                      dtype=np.int64)
    i1 = np.arange(1, E + 1, dtype=np.int64)
    write_series(w, offs - i1 * eb, width_field_bits=6, signed=True)   # Table 1
    write_series(w, gmax - i1 * eg, width_field_bits=6, signed=True)   # Table 1
    for pt, gm in zip(plan.points, gmax):                              # Table 2
        w.write_array(pt.y.astype(np.int64), _STATE_BITS)
        d = gm - pt.group_ids(plan.ways)
        assert (d >= 0).all()
        write_series(w, d, width_field_bits=4, signed=False)
    return w.getvalue()


def deserialize_plan(data: bytes) -> RecoilPlan:
    r = BitReader(data)
    hdr = {name: r.read(bits) for name, bits in _HDR_FIELDS}
    M, W = hdr["n_threads"], hdr["ways"]
    E = M - 1
    if E == 0:
        return RecoilPlan(points=(), n_symbols=hdr["n_symbols"],
                          n_words=hdr["n_words"], ways=W)
    eb = _ceil_div(hdr["n_words"], M)
    G = _ceil_div(hdr["n_symbols"], W)
    eg = _ceil_div(G, M)
    i1 = np.arange(1, E + 1, dtype=np.int64)
    offs = read_series(r, E, width_field_bits=6, signed=True) + i1 * eb
    gmax = read_series(r, E, width_field_bits=6, signed=True) + i1 * eg
    points = []
    lanes = np.arange(W, dtype=np.int64)
    for i in range(E):
        y = r.read_array(W, _STATE_BITS).astype(np.uint32)
        d = read_series(r, W, width_field_bits=4, signed=False)
        k = (gmax[i] - d) * W + lanes
        points.append(SplitPoint(offset=int(offs[i]), k=k, y=y))
    return RecoilPlan(points=tuple(points), n_symbols=hdr["n_symbols"],
                      n_words=hdr["n_words"], ways=W)


def serialized_size_bytes(plan: RecoilPlan) -> int:
    return len(serialize_plan(plan))
