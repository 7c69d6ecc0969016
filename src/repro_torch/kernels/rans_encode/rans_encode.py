"""Hopper CUDA kernels for the Recoil ingest, their wrappers and their plain
torch versions.

The kernels live in ``csrc/rans_encode.cu`` (see its header for the
design): ``encode_scan_kernel`` computes the JAX package's
``core/encode/ops.py::encode_scan``, and three kernels launched by one
call -- a parallel cover pass, the slot chain and the emit pass -- its
``plan_split_scan``.  They are built and loaded by the port's one recipe
(:mod:`repro_torch.kernels.build`) and bound with ``ctypes``.

The encode kernel reads a model's frequencies as a table of encoder
records (:func:`encoder_table`), which its owner builds once and passes on
every call.

Each wrapper:

  * on CPU tensors runs its plain torch version (same module) and bumps
    its ``plain_calls`` counter;
  * on CUDA tensors checks them, launches its kernel on PyTorch's current
    stream and bumps its ``launches`` counter — or raises.  There is no
    fallback from the kernel to the plain version.

u32 values (states) travel as int32 bit patterns and the 16-bit words as
int16 bit patterns, as in the walk kernels.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from ..build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "rans_encode.cu"
MASK32 = 0xFFFFFFFF
ROUNDS = 8          # the oracle's retry budget (heuristic.plan_split_offsets)
MAX_FREQ = 1 << 16  # the largest frequency a record holds (n_bits <= 16)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rans_encode_scan.argtypes = [p, p, p, p, i, i, p, i, i, i, p, p, p,
                                     p, p, p]
    lib.rans_encode_scan.restype = i
    lib.rans_plan_splits.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i,
                                     p, p, p, p, p, p]
    lib.rans_plan_splits.restype = i
    lib.rans_plan_cover.argtypes = [p, i, p, p, i, i, i, p, p]
    lib.rans_plan_cover.restype = i
    lib.rans_encode_error_string.argtypes = [i]
    lib.rans_encode_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary(SOURCE, "librans_encode", _bind)
load_library = LIBRARY.load


def reset_counts() -> None:
    """Zero the wrappers' ``launches`` and ``plain_calls``."""
    for fn in (encode_scan, plan_splits, plan_cover):
        fn.launches = 0
        fn.plain_calls = 0


def _bits32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 bit patterns."""
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)


def _bits16(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^16) as int16 bit patterns."""
    return torch.where(t >= 2 ** 15, t - 2 ** 16, t).to(torch.int16)


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != \
            tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous {dtype}{list(shape)} on {dev}, got "
            f"{t.dtype}{list(t.shape)} on {t.device}")


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.rans_encode_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# Encode scan
# ---------------------------------------------------------------------------

def _ctx_alphabet(f_tab) -> tuple[int, int]:
    """``(contexts, alphabet)`` of a static ``[A]`` or adaptive ``[C, A]``
    frequency table."""
    return (f_tab.shape[0] if f_tab.dim() == 2 else 1), f_tab.shape[-1]


@dataclass(frozen=True, eq=False)
class EncoderTable:
    """A model's encoder records (:func:`encoder_table`) with what they were
    built for, kept on the host so that a call checks them without reading
    the device."""

    records: torch.Tensor
    n_bits: int
    contexts: int
    alphabet: int


def encoder_table(f_tab, F_tab, n_bits: int) -> EncoderTable:
    """The encoder's records for a static ``[A]`` or adaptive ``[C, A]``
    model (``F_tab`` ``[A + 1]`` / ``[C, A + 1]``, or wider), on
    ``f_tab``'s device: ``records`` is int32 ``[C (A + 1) + 1, 4]`` holding
    u32 bit patterns.

    Row ``c (A + 1) + s`` is symbol s under context c, row
    ``c (A + 1) + A`` context c's record for symbols outside the alphabet
    (f = 0, F = ``F_tab[c, 0]``, as the plain version reads), and the last
    row the inactive slots' record.  A record is ``(thr, mlo, bias, cs)``:

      * ``thr = ~(xmax >> 1)`` with ``xmax = min(f 2^(32 - n), 2^32) - 1``:
        the step renormalizes when x > xmax, and since xmax is odd that is
        when ``(x >> 1) + thr``, read as a signed 32-bit value, is >= 0
        (f = 0: thr = 0, always; the inactive record's -2^31: never);
      * ``mlo = ceil(2^(32 + s) / f) - 2^32`` with ``s = ceil(log2 f)``:
        Granlund and Montgomery's 33-bit magic number, so that
        ``floor(x / f) = (x + umulhi(x, mlo)) >> s`` (the sum in 33 bits)
        for every u32 x; f = 0 divides by 1 (mlo = s = 0), so its step is
        ``x1 2^n + F``, as in the plain version;
      * ``bias = F``;
      * ``cs = (2^n - max(f, 1)) << 5 | s``, the complement as a signed
        27-bit value above the 5-bit shift.

    Frequencies must lie in [0, 2^16].
    """
    if not 1 <= n_bits <= 16:
        raise ValueError(f"n_bits={n_bits} outside [1, 16]")
    C, A = _ctx_alphabet(f_tab)
    if F_tab.dim() != f_tab.dim() or F_tab.shape[-1] < A or A == 0 or \
            (f_tab.dim() == 2 and F_tab.shape[0] != C):
        raise ValueError("F_tab must have f_tab's rows and >= A >= 1 columns")
    f = f_tab.reshape(C, A).long()
    F = F_tab.reshape(C, -1).long()
    lo, hi = torch.stack([f.min(), f.max()]).tolist()
    if lo < 0 or hi > MAX_FREQ:
        raise ValueError(f"frequencies must lie in [0, {MAX_FREQ}], got "
                         f"[{lo}, {hi}]")
    # The out-of-alphabet record of each context: f = 0, F = F_tab[c, 0].
    f = torch.cat([f, f.new_zeros(C, 1)], 1)
    F = torch.cat([F[:, :A], F[:, :1]], 1)
    s = sum((f > (1 << k)).long() for k in range(16))      # ceil(log2 f)
    fd = f.clamp(min=1)
    mlo = ((1 << (32 + s)) + fd - 1) // fd - (1 << 32)
    xmax = (f << (32 - n_bits)).clamp(max=1 << 32) - 1
    thr = torch.where(f == 0, 0, MASK32 - (xmax >> 1))
    cs = (((1 << n_bits) - fd) << 5) | s
    records = torch.stack([thr, mlo, F, cs], -1).reshape(-1, 4)
    inactive = records.new_tensor([[1 << 31, 0, 0, 0]])
    records = _bits32(torch.cat([records, inactive]) & MASK32).contiguous()
    return EncoderTable(records, n_bits, C, A)


def _check_table(table, f_tab, n_bits: int, dev) -> None:
    """Raise unless ``table`` is :func:`encoder_table`'s for a model of
    ``f_tab``'s shape at ``n_bits``, with its records on ``dev``."""
    if not isinstance(table, EncoderTable):
        raise ValueError(f"table: need an EncoderTable, got "
                         f"{type(table).__name__}")
    C, A = _ctx_alphabet(f_tab)
    built, need = (table.n_bits, table.contexts, table.alphabet), \
        (n_bits, C, A)
    if built != need:
        raise ValueError(f"table: built for (n_bits, contexts, alphabet) = "
                         f"{built}, the call needs {need}")
    _check("table", table.records, torch.int32, (C * (A + 1) + 1, 4), dev)


def encode_scan_plain(sym, active, f_tab, F_tab, x0, ctx=None, *,
                      n_bits: int):
    """The plain torch encode: a loop over groups, all contents and ways at
    once.  Same arguments and results as :func:`encode_scan`.

    Gathers are hoisted out of the loop.  An inactive lane carries
    f = 2^n, F = 0, which neither renormalizes (x < 2^32) nor moves the
    state; the step is the kernel's ``((x1 / f) << n) + F + x1 % f``
    written as ``x1 + (x1 / f) * (2^n - f) + F``, with ``f`` read as
    ``max(f, 1)`` in the division, as the kernel does.
    """
    B, G, W = sym.shape
    dev = sym.device
    A = f_tab.shape[-1]
    in_alpha = (sym >= 0) & (sym < A)
    s = torch.where(in_alpha, sym, 0).long()
    if ctx is None:
        f, F = f_tab.long()[s], F_tab.long()[s]
    else:
        c = ctx.long().clamp(0, f_tab.shape[0] - 1)
        f, F = f_tab.long()[c, s], F_tab.long()[c, s]
    f = torch.where(in_alpha, f, 0)
    zero_freq = (active & (f == 0)).reshape(B, -1).any(1)
    scale = 1 << n_bits
    f_eff = torch.where(active, f, scale)
    F_eff = torch.where(active, F, 0)
    fd = f_eff.clamp(min=1)
    gain = scale - fd
    shift = 32 - n_bits
    x = x0.long() & MASK32
    xs = torch.empty((B, G, W), dtype=torch.int64, device=dev)
    for g in range(G):
        xs[:, g] = x
        x1 = torch.where((x >> shift) >= f_eff[:, g], x >> 16, x)
        x = (x1 + (x1 // fd[:, g]) * gain[:, g] + F_eff[:, g]) & MASK32
    masks = active & ((xs >> shift) >= f)
    ys = torch.where(masks, xs >> 16, xs)
    return (_bits16(xs & 0xFFFF), masks, _bits32(ys), _bits32(x), zero_freq)


def encode_scan(sym, active, f_tab, F_tab, x0, ctx=None, *, n_bits: int,
                table=None):
    """W-way interleaved rANS encode of B contents laid out as group grids.

    ``sym`` int32[B, G, W] (symbol of flat index g * W + j at [b, g, j]),
    ``active`` bool[B, G, W] (False on padding and resume lead slots),
    ``f_tab``/``F_tab`` int32 — ``[A]``/``[A + 1]`` for a static model,
    ``[C, A]``/``[C, A + 1]`` for an adaptive one, with ``ctx``
    int32[B, G, W] the context of each slot — and ``x0`` int32[B, W], each
    way's starting state (u32 bit patterns).

    Returns ``(words int16[B, G, W], masks bool[B, G, W], ys int32[B, G, W],
    final int32[B, W], zero_freq bool[B])``: each slot's pre-renormalization
    low word, whether it emitted it, its bounded post-renormalization state
    (u32 bits), each way's final state, and whether an active symbol had
    zero frequency (or lay outside the alphabet).

    ``table`` is :func:`encoder_table` of ``(f_tab, F_tab, n_bits)``, built
    once by the caller that owns the model; a table built for another
    shape or ``n_bits`` raises.  Without one the call builds its own.  The
    plain version reads ``f_tab`` and ``F_tab`` and not the table.  On the
    card W must be a multiple of 4, and ``sym``, ``active``, ``ctx`` and the
    table's records 16-byte aligned.
    """
    if table is not None:
        _check_table(table, f_tab, n_bits, sym.device)
    if sym.device.type == "cpu":
        encode_scan.plain_calls += 1
        return encode_scan_plain(sym, active, f_tab, F_tab, x0, ctx,
                                 n_bits=n_bits)
    dev = sym.device
    if sym.dim() != 3:
        raise ValueError(f"sym must be [B, G, W], got {list(sym.shape)}")
    B, G, W = sym.shape
    if not 1 <= n_bits <= 16:
        raise ValueError(f"n_bits={n_bits} outside [1, 16]")
    if B * G * W >= 2 ** 31 or B * W >= 2 ** 31:
        raise ValueError("the group grid must hold fewer than 2^31 slots")
    if W % 4:
        raise ValueError(f"the encode kernel takes W a multiple of 4, got {W}")
    _check("sym", sym, torch.int32, (B, G, W), dev)
    _check("active", active, torch.bool, (B, G, W), dev)
    _check("x0", x0, torch.int32, (B, W), dev)
    adaptive = f_tab.dim() == 2
    n_ctx, A = _ctx_alphabet(f_tab)
    _check("f_tab", f_tab, torch.int32, (n_ctx, A) if adaptive else (A,),
           dev)
    if F_tab.dim() != f_tab.dim() or F_tab.shape[-1] < A or \
            (adaptive and F_tab.shape[0] != n_ctx):
        raise ValueError("F_tab must have f_tab's rows and >= A columns")
    _check("F_tab", F_tab, torch.int32, F_tab.shape, dev)
    if adaptive:
        if ctx is None:
            raise ValueError("an adaptive table needs a ctx grid")
        _check("ctx", ctx, torch.int32, (B, G, W), dev)
    elif ctx is not None:
        raise ValueError("ctx given with a static table")
    if table is None:
        table = encoder_table(f_tab, F_tab, n_bits)
    for name, t in (("sym", sym), ("active", active), ("ctx", ctx),
                    ("table", table.records)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    words = torch.empty((B, G, W), dtype=torch.int16, device=dev)
    masks = torch.empty((B, G, W), dtype=torch.bool, device=dev)
    ys = torch.empty((B, G, W), dtype=torch.int32, device=dev)
    final = torch.empty((B, W), dtype=torch.int32, device=dev)
    zero_freq = torch.zeros(B, dtype=torch.int32, device=dev)
    if B * W:
        lib = load_library()
        err = lib.rans_encode_scan(
            sym.data_ptr(), active.data_ptr(),
            None if ctx is None else ctx.data_ptr(),
            table.records.data_ptr(), A, n_ctx, x0.data_ptr(), B, G, W,
            words.data_ptr(), masks.data_ptr(), ys.data_ptr(),
            final.data_ptr(),
            zero_freq.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, err, "rans_encode_scan")
        encode_scan.launches += 1
    return words, masks, ys, final, zero_freq != 0


# ---------------------------------------------------------------------------
# Definition-4.1 split planning
# ---------------------------------------------------------------------------

def _scan_candidates(kw, last, qs, W: int):
    """Backward scans of candidate offsets ``qs`` in symbol space: way j's
    last emission at offset <= q is its last emitted symbol <= kw[q], in
    group ``last[t, j]`` with ``t = floor((kw[q] - j) / W)``.  Returns
    ``(g2 int64[Q, W], ok bool[Q])`` — the groups, and whether every way
    has such an emission."""
    lanes = torch.arange(W, device=kw.device)
    t = (kw[qs].long()[:, None] - lanes) // W
    g2 = torch.where(t >= 0, last[t.clamp(min=0), lanes].long(), -1)
    return g2, (g2 >= 0).all(1)


def plan_splits_plain(k_of_word, csum, last, ys, n_words, n_symbols,
                      n_splits, *, window: int, n_slots: int):
    """The oracle-shaped plain planner: the oracle's loops over slots and
    rounds, each round's whole window scanned backward over the W ways at
    once.  Same arguments and results as :func:`plan_splits`; the
    reference both :func:`plan_splits_by_cover` and the kernels are held
    to."""
    B, G, W = last.shape
    dev = last.device
    found, q_out, k_out, y_out = _plan_outputs(B, n_slots, W, dev)
    lanes = torch.arange(W, device=dev)
    for b, (NW, N, M) in enumerate(zip(n_words.tolist(), n_symbols.tolist(),
                                       n_splits.tolist())):
        if M <= 1 or NW == 0 or N <= 0:
            continue
        kw, lst = k_of_word[b], last[b]
        c_prev = min_q = 0
        for m in range(min(M - 1, n_slots)):
            T = -(-(N - c_prev) // (M - m))
            target = c_prev + T
            if target >= N:
                break
            center = int(csum[b, target - 1])
            lo, hi = max(min_q, center - window), min(NW - 1, center + window)
            got = False
            for _ in range(ROUNDS):
                if hi < lo:
                    break
                qs = torch.arange(lo, hi + 1, device=dev)
                g2, ok = _scan_candidates(kw, lst, qs, W)
                k = g2 * W + lanes
                c, a = k.min(1).values, k.max(1).values
                valid = ok & (c > c_prev)
                if bool(valid.any()):
                    h = (a - c_prev + 1 - T).abs() + (c - c_prev - T).abs()
                    best = int(torch.where(valid, h, 2 ** 62).argmin())
                    found[b, m] = True
                    q_out[b, m] = lo + best
                    k_out[b, m] = k[best].int()
                    y_out[b, m] = ys[b, g2[best], lanes]
                    c_prev, min_q = int(c[best]), lo + best + 1
                    got = True
                    break
                lo = max(min_q, lo - 2 * window)
                hi = min(NW - 1, hi + 2 * window)
            if not got:
                break
    return found, q_out, k_out, y_out


def plan_cover_plain(k_of_word, last, n_words):
    """The plain cover pass: ``c int32[B, cap]``, for each word q of content
    b the least k_j of its backward scan (:func:`_scan_candidates`), -1 past
    ``n_words[b]``.

    The scan's W entries ``t_j W + j`` are the W consecutive flat symbols
    ``p`` in ``[kq - W + 1, kq]`` (``kq = k_of_word[b, q]``), so ``c`` is
    the minimum of ``last[p] W + p mod W`` over that window, with ``p``
    itself for ``p < 0`` (a way with no emission yet), as the kernel
    computes it.  ``c < 0`` exactly when some way has no emission at or
    below word q.
    """
    B, G, W = last.shape
    cap = k_of_word.shape[1]
    dev = last.device
    cover = torch.full((B, cap), -1, dtype=torch.int32, device=dev)
    window = torch.arange(1 - W, 1, device=dev)
    for b, NW in enumerate(n_words.tolist()):
        flat = last[b].reshape(-1).long()
        for q0 in range(0, NW, 1 << 18):        # bounds the [Q, W] temporary
            kq = k_of_word[b, q0:min(NW, q0 + (1 << 18))].long()
            p = kq[:, None] + window
            k = torch.where(p >= 0, flat[p.clamp(min=0)] * W + p % W, p)
            cover[b, q0:q0 + kq.numel()] = k.min(1).values.int()
    return cover


def plan_cover(k_of_word, last, n_words):
    """The cover pass alone (the planner's first kernel, which
    :func:`plan_splits` launches itself), ``c int32[B, cap]`` as
    :func:`plan_cover_plain` gives it, so that a check can hold the kernel
    to it on every word; ``k_of_word``, ``last`` and ``n_words`` as in
    :func:`plan_splits`."""
    if last.device.type == "cpu":
        plan_cover.plain_calls += 1
        return plan_cover_plain(k_of_word, last, n_words)
    B, G, W, cap = _check_plan_inputs(k_of_word, last, n_words)
    cover = torch.empty((B, cap), dtype=torch.int32, device=last.device)
    if B:
        lib = load_library()
        err = lib.rans_plan_cover(
            k_of_word.data_ptr(), cap, last.data_ptr(), n_words.data_ptr(),
            B, G, W, cover.data_ptr(),
            torch.cuda.current_stream(last.device).cuda_stream)
        _raise_on(lib, err, "rans_plan_cover")
        plan_cover.launches += 1
    return cover


def _plan_outputs(B: int, n_slots: int, W: int, dev):
    return (torch.zeros((B, n_slots), dtype=torch.bool, device=dev),
            torch.full((B, n_slots), -1, dtype=torch.int32, device=dev),
            torch.zeros((B, n_slots, W), dtype=torch.int32, device=dev),
            torch.zeros((B, n_slots, W), dtype=torch.int32, device=dev))


def plan_splits_by_cover(k_of_word, csum, last, ys, n_words, n_symbols,
                         n_splits, *, window: int, n_slots: int):
    """The plain version of the card's decomposition: the cover pass
    (:func:`plan_cover_plain`), the slot chain over ``k_of_word`` and ``c``
    alone (each round evaluates only the candidates it adds; a candidate
    is valid when ``c > c_prev`` and scores ``h`` with ``a = k_of_word``),
    then the emit step.  Same arguments and results as
    :func:`plan_splits`."""
    B, G, W = last.shape
    dev = last.device
    found, q_out, k_out, y_out = _plan_outputs(B, n_slots, W, dev)
    cover = plan_cover_plain(k_of_word, last, n_words)
    lanes = torch.arange(W, device=dev)
    for b, (NW, N, M) in enumerate(zip(n_words.tolist(), n_symbols.tolist(),
                                       n_splits.tolist())):
        if M <= 1 or NW == 0 or N <= 0:
            continue
        kw, cv = k_of_word[b].long(), cover[b].long()
        c_prev = min_q = 0
        for m in range(min(M - 1, n_slots)):
            T = -(-(N - c_prev) // (M - m))
            target = c_prev + T
            if target >= N:
                break
            center = int(csum[b, target - 1])
            lo, hi = max(min_q, center - window), min(NW - 1, center + window)
            if hi < lo:
                break
            p_lo, p_hi = hi + 1, hi
            got = False
            for _ in range(ROUNDS):
                qs = torch.cat([
                    torch.arange(lo, min(p_lo - 1, hi) + 1, device=dev),
                    torch.arange(max(p_hi + 1, lo), hi + 1, device=dev)])
                c = cv[qs]
                valid = c > c_prev
                if bool(valid.any()):
                    h = (kw[qs] - c_prev + 1 - T).abs() + \
                        (c - c_prev - T).abs()
                    best = int(torch.where(valid, h, 2 ** 62).argmin())
                    found[b, m] = True
                    q_out[b, m] = int(qs[best])
                    c_prev, min_q = int(c[best]), int(qs[best]) + 1
                    got = True
                    break
                p_lo, p_hi = lo, hi
                lo = max(min_q, lo - 2 * window)
                hi = min(NW - 1, hi + 2 * window)
            if not got:
                break
        # The emit step: each found slot's k[W] and y[W].
        rows = found[b].nonzero().flatten()
        kq = kw[q_out[b, rows].long()]
        t = torch.where(lanes <= (kq % W)[:, None], kq[:, None] // W,
                        kq[:, None] // W - 1)
        g2 = last[b][t, lanes].long()
        k_out[b, rows] = (g2 * W + lanes).int()
        y_out[b, rows] = ys[b][g2, lanes]
    return found, q_out, k_out, y_out


def _check_plan_inputs(k_of_word, last, n_words) -> tuple:
    """``(B, G, W, cap)`` of the planner's inputs on the card; raises on a
    shape, dtype, device or layout the kernels do not take."""
    dev = last.device
    if last.dim() != 3 or k_of_word.dim() != 2:
        raise ValueError("last must be [B, G, W] and k_of_word [B, cap]")
    B, G, W = last.shape
    cap = k_of_word.shape[1]
    if B * G * W >= 2 ** 31 or B * cap >= 2 ** 31 or cap == 0:
        raise ValueError("plan_splits: sizes out of range")
    _check("k_of_word", k_of_word, torch.int32, (B, cap), dev)
    _check("last", last, torch.int32, (B, G, W), dev)
    _check("n_words", n_words, torch.int32, (B,), dev)
    if k_of_word.data_ptr() % 16:
        raise ValueError("k_of_word must be 16-byte aligned")
    return B, G, W, cap


def plan_splits(k_of_word, csum, last, ys, n_words, n_symbols, n_splits, *,
                window: int, n_slots: int):
    """Greedy Def-4.1 split selection for B contents, bit-exact against
    ``heuristic.plan_split_offsets``.

    Per content b: ``k_of_word`` int32[B, cap] the emission log (flat symbol
    index of each stream word, ascending), ``csum`` int32[B, G * W] the
    inclusive emission count over flat symbol indices (``csum[k]`` = the
    offset of the first emission past symbol k), ``last`` int32[B, G, W] the
    last group <= g in which way j emitted (-1 before its first), ``ys``
    int32[B, G, W] the bounded states (u32 bits), and ``n_words``,
    ``n_symbols``, ``n_splits`` int32[B].

    Returns per slot ``(found bool[B, S], q int32[B, S], k int32[B, S, W],
    y int32[B, S, W])`` for ``S = n_slots``; the slots a content fills are
    a prefix (planning stops at the first slot with no candidate), the
    others hold ``q = -1`` and zeros.

    On the card one call launches the cover, chain and emit kernels (one
    ``launches``), with an int32[B, cap] scratch for the cover, and takes
    ``k_of_word`` and ``csum`` 16-byte aligned; on the CPU it runs
    :func:`plan_splits_by_cover`.
    """
    if last.device.type == "cpu":
        plan_splits.plain_calls += 1
        return plan_splits_by_cover(k_of_word, csum, last, ys, n_words,
                                    n_symbols, n_splits, window=window,
                                    n_slots=n_slots)
    dev = last.device
    B, G, W, cap = _check_plan_inputs(k_of_word, last, n_words)
    if window < 1 or n_slots < 0 or B * n_slots * max(W, 32) >= 2 ** 31:
        raise ValueError("plan_splits: sizes out of range")
    _check("csum", csum, torch.int32, (B, G * W), dev)
    _check("ys", ys, torch.int32, (B, G, W), dev)
    if csum.data_ptr() % 16:
        raise ValueError("csum must be 16-byte aligned")
    for name, t in (("n_symbols", n_symbols), ("n_splits", n_splits)):
        _check(name, t, torch.int32, (B,), dev)
    found, q_out, k_out, y_out = _plan_outputs(B, n_slots, W, dev)
    if B and n_slots:
        cover = torch.empty((B, cap), dtype=torch.int32, device=dev)
        lib = load_library()
        err = lib.rans_plan_splits(
            k_of_word.data_ptr(), cap, csum.data_ptr(), last.data_ptr(),
            ys.data_ptr(), n_words.data_ptr(), n_symbols.data_ptr(),
            n_splits.data_ptr(), B, G, W, n_slots, window, found.data_ptr(),
            q_out.data_ptr(), k_out.data_ptr(), y_out.data_ptr(),
            cover.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, err, "rans_plan_splits")
        plan_splits.launches += 1
    return found, q_out, k_out, y_out


reset_counts()
