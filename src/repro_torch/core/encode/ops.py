"""The ingest pipeline in torch: encode scan, emission compaction and
Definition-4.1 split planning, on the device the inputs lie on.

Counterpart of the JAX package's ``core/encode/ops.py``; the outputs are the
reference's, bit for bit, and the method is the port's own:

  * :func:`encode_scan` — the W-lane group-stepped interleaved encoder
    (paper §4.1).  Sequential over groups, so it is a hand-written kernel
    on the card (``kernels.rans_encode``); the wrapper runs its plain
    torch version on CPU tensors.
  * :func:`emission_layout` and :func:`compact_emissions` — ordinary torch.
    Emission order is row-major (g, j) order, so ``nonzero`` of the
    flattened emit mask IS ``k_of_word``; the flat inclusive cumsum of the
    mask gives each emission's stream offset and the heuristic's
    ``offset_of_symbol``, and a cummax over groups gives each way's last
    emitting group (the backward scan's lookup table).
  * :func:`plan_split_scan` — the greedy heuristic, the second kernel.  It
    evaluates the oracle's retry rounds lazily, as the oracle does.
  * :func:`ingest_pipeline` — all of the above plus the symbol-indexed
    permutation: symbols in, stream + emission log + split metadata out,
    with the stream left on the device.
"""

from __future__ import annotations

import torch

from ...kernels.rans_encode import rans_encode
from ..engine.plan import pow2_bucket

INT32_MAX = 2 ** 31 - 1


def encode_scan(sym_gw, active_gw, f_tab, F_tab, n_bits: int, ways: int,
                ctx_gw=None, x0=None, table=None):
    """Group-stepped W-lane interleaved rANS encode (paper Eq. 1+3).

    ``sym_gw``/``active_gw`` (and ``ctx_gw``) are [G, W] grids, or
    [B, G, W] for B contents.  Returns ``((final u32[W], zero_freq bool),
    (words u16[G, W], masks bool[G, W], ys u32[G, W]))`` — with a leading
    B axis on every array for batched grids — u32 values as int32 and u16
    words as int16 bit patterns.  ``x0`` (u32[W] bits, or [B, W]) resumes
    each way's state chain; ``None`` starts every way at 2^16.  ``table``
    is the model's encoder records
    (:func:`~repro_torch.kernels.rans_encode.rans_encode.encoder_table`),
    which the caller builds once; without it the kernel's call builds them.
    """
    single = sym_gw.dim() == 2
    if single:
        sym_gw, active_gw = sym_gw[None], active_gw[None]
        ctx_gw = None if ctx_gw is None else ctx_gw[None]
    B = sym_gw.shape[0]
    if x0 is None:
        x0 = torch.full((B, ways), 1 << 16, dtype=torch.int32,
                        device=sym_gw.device)
    elif single:
        x0 = x0[None]
    words, masks, ys, final, zero_freq = rans_encode.encode_scan(
        sym_gw.contiguous(), active_gw.contiguous(), f_tab, F_tab,
        x0.contiguous(), None if ctx_gw is None else ctx_gw.contiguous(),
        n_bits=n_bits, table=table)
    if single:
        return (final[0], zero_freq[0]), (words[0], masks[0], ys[0])
    return (final, zero_freq), (words, masks, ys)


# Entries one scan call takes.  torch's CUDA cumsum of a row of
# 1,732,771,840 flags faulted (an illegal memory access; torch 2.11, H100)
# where one of 896,532,480 ran, so longer rows are scanned in pieces; the
# running max over groups goes in pieces of as many grid entries, which
# bounds its transposed copies and int64 indices to a piece.
SCAN_PIECE = 1 << 28


def _row_cumsum(flat: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum along dim 1 of a [B, n] tensor, in pieces of
    at most SCAN_PIECE entries, each offset by the running total before
    it."""
    n = flat.shape[1]
    if n <= SCAN_PIECE:
        return flat.cumsum(1, dtype=torch.int32)
    out = torch.empty(flat.shape, dtype=torch.int32, device=flat.device)
    carry = None
    for lo in range(0, n, SCAN_PIECE):
        part = flat[:, lo:lo + SCAN_PIECE].cumsum(1, dtype=torch.int32)
        if carry is not None:
            part += carry
        out[:, lo:lo + part.shape[1]] = part
        carry = part[:, -1:]
    return out


def emission_layout(masks: torch.Tensor):
    """Cumulative structures over the [B, G, W] emit grid.

    Returns ``(csum int32[B, G * W], last int32[B, G, W], n_words
    int64[B])``: the inclusive emission count over flat symbol indices
    (``csum[k]`` emissions at symbols <= k, so emission k's stream offset
    is ``csum[k] - 1``), and for each (g, j) the last group <= g in which
    way j emitted (-1 before its first emission).
    """
    B, G, W = masks.shape
    flat = masks.reshape(B, G * W)
    csum = _row_cumsum(flat)
    groups = torch.arange(G, dtype=torch.int32, device=masks.device)
    last = torch.empty((B, G, W), dtype=torch.int32, device=masks.device)
    step = SCAN_PIECE // W
    carry = None
    for lo in range(0, G, step):
        hi = min(G, lo + step)
        # The running max runs along each way's row of the transposed grid:
        # a scan over the innermost dimension, which torch parallelizes
        # within a row (over the group axis in place it gives each column
        # one thread).
        emitted = torch.where(masks[:, lo:hi], groups[lo:hi, None],
                              -1).transpose(1, 2)
        part = torch.cummax(emitted.contiguous(), 2).values
        if carry is not None:
            part = torch.maximum(part, carry)
        last[:, lo:hi] = part.transpose(1, 2)
        carry = part[:, :, -1:]
    return csum, last, flat.sum(1)


def compact_emissions(words, ys, masks, csum, cap: int):
    """Stream compaction into emission order: ``(stream int16[B, cap],
    k_of_word int32[B, cap], y_of_word int32[B, cap])``, each content's
    emissions first, then zeros (``k_of_word``: int32 max, so it stays
    sorted).  ``cap`` is at least the largest content's word count."""
    B = masks.shape[0]
    n = masks[0].numel()
    dev = masks.device
    stream = torch.zeros((B, cap), dtype=torch.int16, device=dev)
    k_of_word = torch.full((B, cap), INT32_MAX, dtype=torch.int32,
                           device=dev)
    y_of_word = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    # The emissions' flat (content, symbol) indices.  Each one's content,
    # symbol and flat offset in the [B, cap] outputs are formed SCAN_PIECE
    # emissions at a time, which bounds those int64 temporaries (a
    # 1.73 G-symbol leaf emits 0.8 G words).
    f = torch.nonzero(masks.reshape(-1)).squeeze(1)
    for lo in range(0, f.numel(), SCAN_PIECE):
        fp = f[lo:lo + SCAN_PIECE]
        dest = csum.reshape(-1)[fp].long()
        dest += torch.div(fp, n, rounding_mode="floor").mul_(cap)
        dest -= 1
        stream.view(-1)[dest] = words.reshape(-1)[fp]
        k_of_word.view(-1)[dest] = fp.remainder(n).to(torch.int32)
        y_of_word.view(-1)[dest] = ys.reshape(-1)[fp]
    return stream, k_of_word, y_of_word


def plan_split_scan(k_of_word, csum, last, ys, n_words, n_symbols, n_splits,
                    *, window: int, n_slots: int):
    """Greedy Def-4.1 split selection, bit-exact against
    ``heuristic.plan_split_offsets``: per slot ``(found bool[B, S],
    q int32[B, S], k int32[B, S, W], y u32[B, S, W] as int32)``."""
    return rans_encode.plan_splits(
        k_of_word, csum, last, ys, n_words, n_symbols, n_splits,
        window=window, n_slots=n_slots)


def ingest_pipeline(sym_gw, active_gw, f_tab, F_tab, n_symbols, n_splits,
                    ctx_gw=None, x0=None, *, n_bits: int, ways: int,
                    window: int, table=None):
    """symbols -> (stream, emission log, final states, split plan) on the
    inputs' device, for B contents at once.

    ``sym_gw``/``active_gw``/``ctx_gw`` are [B, G, W] grids and
    ``n_symbols``/``n_splits`` int32[B] tensors (``n_symbols`` counts a
    content's grid slots up to its last symbol, lead slots included), and
    ``table`` the model's encoder records, as in :func:`encode_scan`.
    Returns a dict of tensors with a leading B axis; ``n_words`` also comes
    back as a list of ints, since sizing the compacted stream needs it on
    the host anyway.  The stream and the permutation are zero-padded to the
    pow2 buckets (floor 1024) of the largest content's word and grid slot
    counts, so a content's rows serve as its resident copies as they are.
    """
    (final, zero_freq), (words, masks, ys) = encode_scan(
        sym_gw, active_gw, f_tab, F_tab, n_bits, ways, ctx_gw=ctx_gw, x0=x0,
        table=table)
    B = masks.shape[0]
    csum, last, n_words_t = emission_layout(masks)
    n_words = n_words_t.tolist()
    cap = pow2_bucket(max(n_words, default=0), 1024)
    stream, k_of_word, y_of_word = compact_emissions(words, ys, masks, csum,
                                                     cap)
    n_slots = max(0, max(n_splits.tolist(), default=1) - 1)
    found, q, k, y = plan_split_scan(
        k_of_word, csum, last, ys, n_words_t.to(torch.int32), n_symbols,
        n_splits, window=window, n_slots=n_slots)
    # The emission grid IS the symbol-indexed permutation: entry (g, j)
    # holds the word emitted at flat symbol g * W + j, 0 where none was.
    _, G, W = masks.shape
    by_symbol = torch.zeros((B, pow2_bucket(G * W, 1024)), dtype=words.dtype,
                            device=words.device)
    torch.where(masks, words, words.new_zeros(()),
                out=by_symbol[:, :G * W].view(B, G, W))
    return {
        "stream": stream, "k_of_word": k_of_word, "y_of_word": y_of_word,
        "by_symbol": by_symbol, "final_states": final, "n_words": n_words,
        "split_found": found, "split_q": q, "split_k": k, "split_y": y,
        "zero_freq": zero_freq,
    }
