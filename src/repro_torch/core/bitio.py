"""Bit-level writer/reader used by the metadata serializer (paper §4.3).

The metadata format packs difference values at data-series granularity with a
4-bit "bits-per-element minus one" header, so sub-byte access is required.
Fully vectorized: the writer buffers (values, nbits) chunks and expands them
to a single bit plane with numpy on flush; the reader unpacks the buffer to a
bit plane once and slices it.  MSB-first within each field.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    def __init__(self):
        self._chunks: list[tuple[np.ndarray, int]] = []  # (values i64, nbits)
        self._total = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits < 0 or (nbits == 0 and value != 0):
            raise ValueError(f"cannot write value {value} in {nbits} bits")
        if nbits > 64:
            raise ValueError("max 64 bits per write")
        if value < 0 or (nbits < 64 and value >= (1 << max(nbits, 1))):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        if nbits:
            self.write_array(np.asarray([value], dtype=np.int64), nbits)

    def write_array(self, values: np.ndarray, nbits: int) -> None:
        values = np.asarray(values, dtype=np.int64).ravel()
        if values.size == 0 or nbits == 0:
            if nbits == 0 and np.any(values != 0):
                raise ValueError("cannot write nonzero values in 0 bits")
            return
        if values.min() < 0:
            raise ValueError("writer takes non-negative values (zigzag first)")
        if nbits < 64 and values.max() >= (1 << nbits):
            raise ValueError(f"values do not fit in {nbits} bits")
        self._chunks.append((values, int(nbits)))
        self._total += values.size * nbits

    @property
    def bit_length(self) -> int:
        return self._total

    def getvalue(self) -> bytes:
        """Pack MSB-first into bytes."""
        if self._total == 0:
            return b""
        planes = []
        for values, nbits in self._chunks:
            shifts = np.arange(nbits - 1, -1, -1, dtype=np.int64)
            planes.append(((values[:, None] >> shifts) & 1).astype(np.uint8).ravel())
        bits = np.concatenate(planes)
        return np.packbits(bits).tobytes()


class BitReader:
    def __init__(self, data: bytes):
        self._bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self._pos = 0

    def read(self, nbits: int) -> int:
        return int(self.read_array(1, nbits)[0]) if nbits else 0

    def read_array(self, count: int, nbits: int) -> np.ndarray:
        if nbits == 0:
            return np.zeros(count, dtype=np.int64)
        end = self._pos + count * nbits
        if end > self._bits.size:
            raise EOFError("bit stream exhausted")
        chunk = self._bits[self._pos:end].reshape(count, nbits).astype(np.int64)
        self._pos = end
        weights = (np.int64(1) << np.arange(nbits - 1, -1, -1, dtype=np.int64))
        return chunk @ weights

    @property
    def bit_pos(self) -> int:
        return self._pos


def zigzag_encode(v: np.ndarray | int):
    """Map signed -> unsigned: 0,-1,1,-2,2 -> 0,1,2,3,4."""
    v = np.asarray(v, dtype=np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.int64)


def zigzag_decode(u: np.ndarray | int):
    u = np.asarray(u, dtype=np.int64)
    return ((u >> 1) ^ -(u & 1)).astype(np.int64)


def series_bit_width(values: np.ndarray) -> int:
    """Paper §4.3: bits per element = max(ceil(log2(v+1)), 1); stored minus 1.

    Values must be non-negative. Zero-filled series still use 1 bit/element
    (footnote 1 of the paper).
    """
    values = np.asarray(values, dtype=np.int64)
    if values.size == 0:
        return 1
    if values.min() < 0:
        raise ValueError("series values must be non-negative (zigzag first)")
    vmax = int(values.max())
    return max(int(vmax).bit_length(), 1)


def write_series(writer: BitWriter, values: np.ndarray, *, width_field_bits: int = 4,
                 signed: bool = False) -> None:
    """Write one data series in the paper's format:

    [width-1 : width_field_bits bits][elements : width bits each]

    Signed series are zigzag-mapped first (the paper stores an explicit sign
    bit; zigzag is the same cost for the common near-zero case and never
    worse by more than the sign bit, and round-trips identically).
    """
    values = np.asarray(values, dtype=np.int64)
    if signed:
        values = zigzag_encode(values)
    width = series_bit_width(values)
    if width - 1 >= (1 << width_field_bits):
        raise ValueError(f"series width {width} exceeds field capacity")
    writer.write(width - 1, width_field_bits)
    writer.write_array(values, width)


def read_series(reader: BitReader, count: int, *, width_field_bits: int = 4,
                signed: bool = False) -> np.ndarray:
    width = reader.read(width_field_bits) + 1
    values = reader.read_array(count, width)
    if signed:
        values = zigzag_decode(values)
    return values
