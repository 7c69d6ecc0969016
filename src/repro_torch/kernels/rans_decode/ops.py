"""Public one-shot entry point for the walk-decode kernels.

``decode(batch, stream, model, n_symbols, device=...)`` uploads one
WalkBatch's split arrays, the stream and the slot tables to ``device`` and
runs the pointer-layout wrapper: the CUDA kernel on ``"cuda"`` (the
default), the plain torch walk on ``"cpu"``.  The kernels read the (S, W)
split arrays and the whole resident stream directly, so none of the TPU
path's lane packing, per-block slabs or tile scatter exists here: the
scatter is the kernels' epilogue.  :func:`scatter_outputs` keeps the tile
-> flat scatter as a plain function for tests that hold tiles.

For steady-state serving use :class:`repro_torch.core.engine.DecoderSession`,
which keeps tables and streams resident behind a bucketed plan cache.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.engine.plan import SPLIT_FIELDS, pad_split_arrays
from ...core.rans import StaticModel
from ...core.vectorized import WalkBatch, _scatter_kept, lut_arrays
from ...device import resolve_device
from .rans_decode import walk_decode_pointer


def packed_lut_ok(model: StaticModel) -> bool:
    """True iff the §4.4 packed single-int32 LUT layout fits this model."""
    return model.alphabet_size <= 256 and model.params.n_bits <= 12


def _luts(model: StaticModel, packed: bool, device) -> tuple:
    """Device-resident slot tables ``(sym_lut, f_lut, F_lut)``; the last two
    are None under the packed layout."""
    return tuple(None if a is None else torch.as_tensor(a, device=device)
                 for a in lut_arrays(model, packed))


def scatter_outputs(tiles: torch.Tensor, g_hi: torch.Tensor,
                    out_base: torch.Tensor, *, n_symbols: int) -> torch.Tensor:
    """(S, T, W) tiles (-1 = not kept) -> flat int32[n_symbols].  The plain
    form of the scatter the CUDA kernels do as their epilogue."""
    S, T, W = tiles.shape
    return _scatter_kept(tiles, tiles >= 0, g_hi, out_base, ways=W,
                         n_steps=T, n_symbols=n_symbols)


def decode(batch: WalkBatch, stream: np.ndarray, model: StaticModel,
           n_symbols: int, *, device="cuda",
           packed_lut: bool | None = None) -> torch.Tensor:
    """Decode a planned WalkBatch into the flat int32 symbol tensor on
    ``device``.

    ``packed_lut=None`` (auto) uses the §4.4 packed LUT whenever the model
    fits it (8-bit symbols, n <= 12); the result is bit-identical either way.
    Raises unless every output position was decoded (one device reduction
    and a host sync).
    """
    dev = resolve_device(device)
    if packed_lut is None:
        packed_lut = packed_lut_ok(model)
    elif packed_lut and not packed_lut_ok(model):
        raise ValueError("packed LUT requires 8-bit symbols and n <= 12")
    if n_symbols >= 2 ** 31:
        raise ValueError(
            f"n_symbols={n_symbols} exceeds int32 device-scatter indices")
    words = np.ascontiguousarray(stream).astype(np.uint16).view(np.int16)
    if words.size == 0:
        words = np.zeros(1, np.int16)    # never read; keeps the pointer valid
    arrs = pad_split_arrays(batch, batch.k.shape[0], dev)
    out, _qf = walk_decode_pointer(
        torch.as_tensor(words, device=dev), *_luts(model, packed_lut, dev),
        *(arrs[f] for f in SPLIT_FIELDS),
        n_bits=model.params.n_bits, ways=batch.ways, n_steps=batch.n_steps,
        n_symbols=n_symbols)
    if not bool((out >= 0).all()):
        raise RuntimeError("kernel outputs did not cover all symbols")
    return out


def decode_recoil_kernel(plan, stream, final_states, model: StaticModel,
                         **kw) -> torch.Tensor:
    """Convenience: RecoilPlan -> kernel decode."""
    from ...core.recoil import build_split_states
    splits = build_split_states(plan, final_states)
    batch = WalkBatch.from_splits(splits, plan.ways)
    return decode(batch, stream, model, plan.n_symbols, **kw)
