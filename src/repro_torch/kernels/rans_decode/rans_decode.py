"""Hopper CUDA kernels for the Recoil walk decode, and their wrappers.

The kernels live in ``csrc/rans_walk.cu`` (see its header for the design):
``walk_pointer_kernel`` replaces the Pallas ``_walk_kernel`` and
``walk_symbol_kernel`` replaces ``_walk_kernel_symbol``, each fused with the
output scatter.  They are compiled with ``nvcc`` for ``sm_90a`` at first use
into ``build/repro_torch/`` (cached by a hash of the source and flags) and
bound with ``ctypes`` through plain ``extern "C"`` launchers.

Each wrapper takes the tensors of a decode plan (the argument order of
``engine.plan.SPLIT_FIELDS`` / ``SYMBOL_SPLIT_FIELDS``):

  * on CPU tensors it runs the plain torch walk (``core.vectorized``) and
    bumps its ``plain_calls`` counter;
  * on CUDA tensors it checks them, launches its kernel on PyTorch's
    current stream and bumps its ``launches`` counter — or raises.  There
    is no fallback from the kernel to the plain walk.

u32 values (states, words) travel as int32 bit patterns; a u16 permutation
travels as int16 bit patterns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ...core.vectorized import _walk_batch_impl, _walk_batch_symbol_impl

SOURCE = Path(__file__).resolve().parent / "csrc" / "rans_walk.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BLOCK = 128

_lib = None
_lib_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put it on PATH")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librans_walk_{digest}.so"


def build_library() -> Path:
    """Compile ``rans_walk.cu`` unless this source is already built; returns
    the shared library's path.  The compiler's ``-Xptxas -v`` report (each
    kernel's registers, shared memory and spills) is kept beside it, see
    :func:`ptxas_report`."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: concurrent builders never see a partial file
    return out


def ptxas_report() -> str:
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.rans_walk_pointer.argtypes = [
                p, i, p, p, p, i, p, p, p, p, p, p, p, p, p, p,
                i, i, i, i, p, i, p, p]
            lib.rans_walk_pointer.restype = i
            lib.rans_walk_symbol.argtypes = [
                p, i, i, p, p, p, i, p, p, p, p, p, p, p, p, p, p,
                i, i, i, i, p, i, p]
            lib.rans_walk_symbol.restype = i
            lib.rans_walk_error_string.argtypes = [i]
            lib.rans_walk_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def reset_counts() -> None:
    """Zero both wrappers' ``launches`` and ``plain_calls``."""
    for fn in (walk_decode_pointer, walk_decode_symbol):
        fn.launches = 0
        fn.plain_calls = 0


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_cuda(named: dict, luts: tuple, *, ways: int, n_bits: int,
                n_steps: int, n_symbols: int) -> torch.device:
    """Validate what the kernels take: one CUDA device, int32, contiguous,
    (S, W) per-lane and (S,) per-split arrays, a slot table of 2^n entries,
    power-of-two ways <= 128, and int32-sized counts."""
    dev = named["k"].device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrappers take CUDA or CPU tensors, got {dev}")
    if ways < 1 or ways > BLOCK or ways & (ways - 1):
        raise ValueError(f"ways={ways} must be a power of two <= {BLOCK}")
    if not 1 <= n_bits <= 16:
        raise ValueError(f"n_bits={n_bits} outside [1, 16]")
    S = named["k"].shape[0]
    for name, t in named.items():
        want = (S, ways) if name in ("k", "y", "x0") else (S,)
        if t.device != dev or t.dtype != torch.int32 or \
                tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous int32{list(want)} on {dev}, got "
                f"{t.dtype}{list(t.shape)} on {t.device}")
    sym_lut, f_lut, F_lut = luts
    if (f_lut is None) != (F_lut is None):
        raise ValueError("pass both f_lut and F_lut or neither")
    for t in luts:
        if t is not None and (t.device != dev or t.dtype != torch.int32 or
                              tuple(t.shape) != (1 << n_bits,) or
                              not t.is_contiguous()):
            raise ValueError(f"slot tables must be contiguous int32[2^{n_bits}] "
                             f"on {dev}")
    if f_lut is None and n_bits > 12:
        raise ValueError("the packed slot table requires n <= 12")
    if max(n_steps, n_symbols) >= 2 ** 31:
        raise ValueError("step and output counts must fit int32")
    return dev


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.rans_walk_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def walk_decode_pointer(stream, sym_lut, f_lut, F_lut, k, y, x0, q0, g_hi,
                        start, stop, keep_lo, keep_hi, out_base, *,
                        n_bits: int, ways: int, n_steps: int, n_symbols: int):
    """Pointer-layout walk + scatter.  ``stream`` is int32[n] (16-bit words);
    ``f_lut = F_lut = None`` selects the packed slot table.  Returns
    ``(out int32[n_symbols], qf int32[S])``: -1 where no symbol was kept,
    and each split's final stream pointer."""
    args = (stream, sym_lut, f_lut, F_lut, k, y, x0, q0, g_hi, start, stop,
            keep_lo, keep_hi, out_base)
    statics = dict(n_bits=n_bits, ways=ways, n_steps=n_steps,
                   n_symbols=n_symbols)
    if stream.device.type == "cpu":
        walk_decode_pointer.plain_calls += 1
        return _walk_batch_impl(*args, **statics)
    named = dict(k=k, y=y, x0=x0, q0=q0, g_hi=g_hi, start=start, stop=stop,
                 keep_lo=keep_lo, keep_hi=keep_hi, out_base=out_base)
    dev = _check_cuda(named, (sym_lut, f_lut, F_lut), **statics)
    if stream.device != dev or stream.dtype != torch.int32 or \
            stream.dim() != 1 or stream.numel() == 0 or \
            not stream.is_contiguous() or stream.numel() >= 2 ** 31:
        raise ValueError("stream must be a non-empty contiguous int32[n] on "
                         f"{dev}")
    S = k.shape[0]
    out = torch.full((n_symbols,), -1, dtype=torch.int32, device=dev)
    qf = torch.empty(S, dtype=torch.int32, device=dev)
    if S == 0:
        return out, qf
    lib = load_library()
    err = lib.rans_walk_pointer(
        stream.data_ptr(), stream.numel(), sym_lut.data_ptr(), _ptr(f_lut),
        _ptr(F_lut), sym_lut.numel(), k.data_ptr(), y.data_ptr(),
        x0.data_ptr(), q0.data_ptr(), g_hi.data_ptr(), start.data_ptr(),
        stop.data_ptr(), keep_lo.data_ptr(), keep_hi.data_ptr(),
        out_base.data_ptr(), S, ways, n_bits, n_steps, out.data_ptr(),
        n_symbols, qf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "rans_walk_pointer")
    walk_decode_pointer.launches += 1
    return out, qf


def walk_decode_symbol(by_symbol, sym_lut, f_lut, F_lut, k, y, x0, sym_base,
                       g_hi, start, stop, keep_lo, keep_hi, out_base, *,
                       n_bits: int, ways: int, n_steps: int, n_symbols: int):
    """Symbol-layout (pointer-free) walk + scatter.  ``by_symbol`` is the
    ``words_by_symbol`` permutation as int16 (u16) or int32 (u32) bit
    patterns, a whole number of W-wide groups.  Returns int32[n_symbols]."""
    args = (by_symbol, sym_lut, f_lut, F_lut, k, y, x0, sym_base, g_hi, start,
            stop, keep_lo, keep_hi, out_base)
    statics = dict(n_bits=n_bits, ways=ways, n_steps=n_steps,
                   n_symbols=n_symbols)
    if by_symbol.device.type == "cpu":
        walk_decode_symbol.plain_calls += 1
        return _walk_batch_symbol_impl(*args, **statics)
    named = dict(k=k, y=y, x0=x0, sym_base=sym_base, g_hi=g_hi, start=start,
                 stop=stop, keep_lo=keep_lo, keep_hi=keep_hi,
                 out_base=out_base)
    dev = _check_cuda(named, (sym_lut, f_lut, F_lut), **statics)
    n_perm = by_symbol.numel()
    if by_symbol.device != dev or \
            by_symbol.dtype not in (torch.int16, torch.int32) or \
            by_symbol.dim() != 1 or not by_symbol.is_contiguous() or \
            n_perm == 0 or n_perm % ways or n_perm >= 2 ** 31:
        raise ValueError(
            "by_symbol must be a contiguous int16/int32[n] on "
            f"{dev} with n a non-zero multiple of ways={ways}")
    S = k.shape[0]
    out = torch.full((n_symbols,), -1, dtype=torch.int32, device=dev)
    if S == 0:
        return out
    lib = load_library()
    err = lib.rans_walk_symbol(
        by_symbol.data_ptr(), by_symbol.element_size(), n_perm,
        sym_lut.data_ptr(), _ptr(f_lut), _ptr(F_lut), sym_lut.numel(),
        k.data_ptr(), y.data_ptr(), x0.data_ptr(), sym_base.data_ptr(),
        g_hi.data_ptr(), start.data_ptr(), stop.data_ptr(),
        keep_lo.data_ptr(), keep_hi.data_ptr(), out_base.data_ptr(), S, ways,
        n_bits, n_steps, out.data_ptr(), n_symbols,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "rans_walk_symbol")
    walk_decode_symbol.launches += 1
    return out


reset_counts()
