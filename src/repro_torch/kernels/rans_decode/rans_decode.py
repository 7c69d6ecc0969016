"""Hopper CUDA kernels for the Recoil walk decode, and their wrappers.

The kernels live in ``csrc/rans_walk.cu`` (see its header for the design):
``walk_pointer_kernel`` replaces the Pallas ``_walk_kernel`` and
``walk_symbol_kernel`` replaces ``_walk_kernel_symbol``, each fused with the
output scatter.  They are built and loaded by the port's one recipe
(:mod:`repro_torch.kernels.build`: ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch/``) and bound with ``ctypes`` through plain
``extern "C"`` launchers.

Each wrapper takes the tensors of a decode plan (the argument order of
``engine.plan.SPLIT_FIELDS`` / ``SYMBOL_SPLIT_FIELDS``):

  * on CPU tensors it runs the plain torch walk (``core.vectorized``) and
    bumps its ``plain_calls`` counter;
  * on CUDA tensors it checks them, launches its kernel on PyTorch's
    current stream and bumps its ``launches`` counter — or raises.  There
    is no fallback from the kernel to the plain walk.

The grid covers every split row it is given, in blocks of
``32 * rows_per_block`` threads (:func:`check_rows_per_block`).
``covered`` says that the kept windows tile the output, so the kernel
writes every position and the CUDA path allocates it without the ``-1``
fill; the ``fills`` counter counts the fills it does run.  The plain walks
ignore it and always fill.

u32 values (states) travel as int32 bit patterns; the 16-bit stream words
and permutation entries travel as int16 bit patterns.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...core.vectorized import _walk_batch_impl, _walk_batch_symbol_impl
from ...spans import span
from ..build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "rans_walk.cu"
BLOCK = 128                      # threads a block when rows_per_block is None
MAX_WAYS = 128
ROWS_PER_BLOCK = (1, 2, 4, 8, 16, 32)   # warps a block, 32 to 1024 threads


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rans_walk_pointer.argtypes = [
        p, i, p, p, p, i, p, p, p, p, p, p, p, p, p, p,
        i, i, i, i, p, i, p, i, p]
    lib.rans_walk_pointer.restype = i
    lib.rans_walk_symbol.argtypes = [
        p, i, p, p, p, i, p, p, p, p, p, p, p, p, p, p,
        i, i, i, i, p, i, i, p]
    lib.rans_walk_symbol.restype = i
    lib.rans_walk_error_string.argtypes = [i]
    lib.rans_walk_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary(SOURCE, "librans_walk", _bind)
load_library = LIBRARY.load


def reset_counts() -> None:
    """Zero both wrappers' ``launches``, ``plain_calls`` and ``fills``."""
    for fn in (walk_decode_pointer, walk_decode_symbol):
        fn.launches = 0
        fn.plain_calls = 0
        fn.fills = 0


def check_rows_per_block(rows_per_block, ways: int | None = None) -> int:
    """The walk kernels' block size in threads for ``rows_per_block``.

    The Pallas kernels' ``rows_per_block`` counts 128-lane vector rows a
    grid step; here it counts **warps** a block: ``32 * rows_per_block``
    threads, one of :data:`ROWS_PER_BLOCK` (32 to 1024 threads), holding at
    least one whole W-thread split (``32 * rows_per_block >= ways``).
    ``None`` keeps the default block of :data:`BLOCK` = 128 threads, the
    same instance as ``rows_per_block=4``; the reference tuner's candidates
    ``(4, 8, 16)`` are 128, 256 and 512 threads.  Anything else raises
    ``ValueError`` here, on the host, before any launch."""
    if rows_per_block is None:
        threads = BLOCK
    elif isinstance(rows_per_block, bool) or \
            not isinstance(rows_per_block, int) or \
            rows_per_block not in ROWS_PER_BLOCK:
        raise ValueError(f"rows_per_block={rows_per_block!r} must be None or "
                         f"one of {ROWS_PER_BLOCK} (warps a block)")
    else:
        threads = 32 * rows_per_block
    if ways is not None and threads < ways:
        raise ValueError(f"rows_per_block={rows_per_block} gives {threads} "
                         f"threads, fewer than one split of ways={ways}")
    return threads


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_cuda(named: dict, luts: tuple, *, ways: int, n_bits: int,
                n_steps: int, n_symbols: int) -> torch.device:
    """Validate what the kernels take: one CUDA device, int32, contiguous,
    (S, W) per-lane and (S,) per-split arrays, 16-byte aligned slot tables
    of 2^n entries, power-of-two ways in [8, 128], and int32-sized
    counts."""
    dev = named["k"].device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrappers take CUDA or CPU tensors, got {dev}")
    if ways < 8 or ways > MAX_WAYS or ways & (ways - 1):
        raise ValueError(
            f"ways={ways} must be a power of two in [8, {MAX_WAYS}]")
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
                              not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"slot tables must be contiguous, 16-byte "
                             f"aligned int32[2^{n_bits}] on {dev}")
    if f_lut is None and n_bits > 12:
        raise ValueError("the packed slot table requires n <= 12")
    if max(n_steps, n_symbols) >= 2 ** 31:
        raise ValueError("step and output counts must fit int32")
    return dev


def _check_words(words: torch.Tensor, dev: torch.device, name: str,
                 multiple: int = 1) -> None:
    """The stream or permutation: contiguous, 16-byte aligned int16 (u16 bit
    patterns) on ``dev``, non-empty, a whole number of ``multiple``."""
    n = words.numel()
    if words.device != dev or words.dtype != torch.int16 or \
            words.dim() != 1 or not words.is_contiguous() or n == 0 or \
            n % multiple or n >= 2 ** 31 or words.data_ptr() % 16:
        raise ValueError(
            f"{name} must be a non-empty, contiguous, 16-byte aligned "
            f"int16[n] on {dev} with n a multiple of {multiple}; got "
            f"{words.dtype}{list(words.shape)} on {words.device}")


def _output(fn, n_symbols: int, covered: bool,
            dev: torch.device) -> torch.Tensor:
    """A new int32[n_symbols] output, filled with -1 unless the kernel
    writes every position."""
    if covered:
        return torch.empty(n_symbols, dtype=torch.int32, device=dev)
    fn.fills += 1
    return torch.full((n_symbols,), -1, dtype=torch.int32, device=dev)


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.rans_walk_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def walk_decode_pointer(stream, sym_lut, f_lut, F_lut, k, y, x0, q0, g_hi,
                        start, stop, keep_lo, keep_hi, out_base, *,
                        n_bits: int, ways: int, n_steps: int, n_symbols: int,
                        covered: bool = False,
                        rows_per_block: int | None = None):
    """Pointer-layout walk + scatter.  ``stream`` is the 16-bit words as
    int16 (the plain walk also takes int32); ``f_lut = F_lut = None``
    selects the packed slot table.  ``rows_per_block`` is the block size in
    warps (:func:`check_rows_per_block`; the plain walk checks it and
    ignores it).  Returns ``(out int32[n_symbols], qf int32[S])``: -1 where
    no symbol was kept (unless ``covered``), and each split's final stream
    pointer."""
    args = (stream, sym_lut, f_lut, F_lut, k, y, x0, q0, g_hi, start, stop,
            keep_lo, keep_hi, out_base)
    statics = dict(n_bits=n_bits, ways=ways, n_steps=n_steps,
                   n_symbols=n_symbols)
    block = check_rows_per_block(rows_per_block, ways)
    if stream.device.type == "cpu":
        walk_decode_pointer.plain_calls += 1
        return _walk_batch_impl(*args, **statics)
    named = dict(k=k, y=y, x0=x0, q0=q0, g_hi=g_hi, start=start, stop=stop,
                 keep_lo=keep_lo, keep_hi=keep_hi, out_base=out_base)
    dev = _check_cuda(named, (sym_lut, f_lut, F_lut), **statics)
    _check_words(stream, dev, "stream")
    S = k.shape[0]
    with span("recoil.walk.alloc"):
        out = _output(walk_decode_pointer, n_symbols, covered, dev)
        if S == 0:
            return out, q0.clone()
        qf = torch.empty(S, dtype=torch.int32, device=dev)
    lib = load_library()
    err = lib.rans_walk_pointer(
        stream.data_ptr(), stream.numel(), sym_lut.data_ptr(), _ptr(f_lut),
        _ptr(F_lut), sym_lut.numel(), k.data_ptr(), y.data_ptr(),
        x0.data_ptr(), q0.data_ptr(), g_hi.data_ptr(), start.data_ptr(),
        stop.data_ptr(), keep_lo.data_ptr(), keep_hi.data_ptr(),
        out_base.data_ptr(), S, ways, n_bits, n_steps, out.data_ptr(),
        n_symbols, qf.data_ptr(), block,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "rans_walk_pointer")
    walk_decode_pointer.launches += 1
    return out, qf


def walk_decode_symbol(by_symbol, sym_lut, f_lut, F_lut, k, y, x0, sym_base,
                       g_hi, start, stop, keep_lo, keep_hi, out_base, *,
                       n_bits: int, ways: int, n_steps: int, n_symbols: int,
                       covered: bool = False,
                       rows_per_block: int | None = None):
    """Symbol-layout (pointer-free) walk + scatter.  ``by_symbol`` is the
    ``words_by_symbol`` permutation as int16 (u16) bit patterns (the plain
    walk also takes int32), a whole number of W-wide groups.  Returns
    int32[n_symbols]; the options are :func:`walk_decode_pointer`'s."""
    args = (by_symbol, sym_lut, f_lut, F_lut, k, y, x0, sym_base, g_hi, start,
            stop, keep_lo, keep_hi, out_base)
    statics = dict(n_bits=n_bits, ways=ways, n_steps=n_steps,
                   n_symbols=n_symbols)
    block = check_rows_per_block(rows_per_block, ways)
    if by_symbol.device.type == "cpu":
        walk_decode_symbol.plain_calls += 1
        return _walk_batch_symbol_impl(*args, **statics)
    named = dict(k=k, y=y, x0=x0, sym_base=sym_base, g_hi=g_hi, start=start,
                 stop=stop, keep_lo=keep_lo, keep_hi=keep_hi,
                 out_base=out_base)
    dev = _check_cuda(named, (sym_lut, f_lut, F_lut), **statics)
    _check_words(by_symbol, dev, "by_symbol", ways)
    S = k.shape[0]
    with span("recoil.walk.alloc"):
        out = _output(walk_decode_symbol, n_symbols, covered, dev)
    if S == 0:
        return out
    lib = load_library()
    err = lib.rans_walk_symbol(
        by_symbol.data_ptr(), by_symbol.numel(), sym_lut.data_ptr(),
        _ptr(f_lut), _ptr(F_lut), sym_lut.numel(), k.data_ptr(),
        y.data_ptr(), x0.data_ptr(), sym_base.data_ptr(), g_hi.data_ptr(),
        start.data_ptr(), stop.data_ptr(), keep_lo.data_ptr(),
        keep_hi.data_ptr(), out_base.data_ptr(), S, ways, n_bits, n_steps,
        out.data_ptr(), n_symbols, block,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "rans_walk_symbol")
    walk_decode_symbol.launches += 1
    return out


reset_counts()
