"""Hopper CUDA kernels for the Recoil ingest (encode + split planning).

  csrc/rans_encode.cu — the encode-scan and split-planning kernels
  rans_encode.py      — ctypes binding, wrappers with counters, and the
                        plain torch versions
"""

from .rans_encode import (encode_scan, encode_scan_plain,  # noqa: F401
                          plan_splits, plan_splits_plain)
