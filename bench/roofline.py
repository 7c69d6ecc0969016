"""Roofline count of the codec's walk, from the cell's inputs only.

Basis: bytes only.  A kernel's least time is the bytes its work must move,
each read once and each written once, over the card's peak memory rate.
No operation term is used: operations a symbol are a property of today's
kernel, not of the work, so a redesign could beat such a count.

- Walk (decode): every compressed 16-bit word of the client's container
  read once (2 B), its serialized split metadata and its frequency table
  read once, and the decoded content written once at its own symbol width
  (1 B for a byte symbol, whatever dtype the program returns).

Sizes come from the benchmark's own parse of the client's container
(``reference.parse_container``), never from the program's plan arrays.

Peak: 3.35 TB/s, the H100 SXM's HBM3 rate on NVIDIA's data sheet, which
assumes the card's full 700 W; the run prints the card's ``power.limit``
beside every share.
"""

from __future__ import annotations

import subprocess

PEAK_BYTES_PER_S = 3.35e12
PEAK_BASIS = "3.35 TB/s HBM3, H100 SXM data sheet, at 700 W"


def walk_bytes(n_words: int, metadata_bytes: int, table_bytes: int,
               n_symbols: int, symbol_bytes: int = 1) -> int:
    return 2 * n_words + metadata_bytes + table_bytes + symbol_bytes * n_symbols


def least_seconds(n_bytes: int) -> float:
    return n_bytes / PEAK_BYTES_PER_S


def share_pct(n_bytes: int, kernel_seconds: float) -> float | None:
    """Least time over the kernels' time, in %; None when no kernel time
    was read (never 0 for a share that was not measured)."""
    if kernel_seconds <= 0 or n_bytes <= 0:
        return None
    return 100.0 * least_seconds(n_bytes) / kernel_seconds


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"
