"""Hopper CUDA kernels for Recoil parallel rANS decoding.

  csrc/rans_walk.cu — the pointer- and symbol-layout walk kernels
  rans_decode.py    — nvcc build, ctypes binding, wrappers with counters
  ops.py            — one-shot ``decode`` entry point, slot tables
  ref.py            — plain tile reference with the walk's output contract
"""

from .ops import decode, decode_recoil_kernel  # noqa: F401
from .ref import decode_reference, walk_reference  # noqa: F401
