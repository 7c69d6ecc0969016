"""Plain reference with the walk's tile contract.

Mirrors the JAX package's ``kernels/rans_decode/ref.py``: (S, T, W) int32
symbol tiles with -1 where a position is not kept, plus each split's final
stream pointer, from the plain pointer walk of
:mod:`repro_torch.core.vectorized` on the CPU.  The CUDA kernels never
build tiles (they scatter as they go); tests compare their flat output and
``qf`` with :func:`decode_reference` and this tile walk.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.rans import StaticModel
from ...core.vectorized import WalkBatch, _cpu, _cpu_luts, _walk_pointer_tiles


def walk_reference(batch: WalkBatch, stream: np.ndarray, model: StaticModel):
    """Returns (tiles int32[S, T, W] with -1 = not kept, qf int32[S])."""
    words = torch.from_numpy(np.ascontiguousarray(stream).astype(np.int32))
    syms, keeps, qf = _walk_pointer_tiles(
        words, *_cpu_luts(model, False), _cpu(batch.k), _cpu(batch.y),
        _cpu(batch.x0), _cpu(batch.q0), _cpu(batch.g_hi), _cpu(batch.start),
        _cpu(batch.stop), _cpu(batch.keep_lo), _cpu(batch.keep_hi),
        n_bits=model.params.n_bits, ways=batch.ways, n_steps=batch.n_steps)
    tiles = torch.where(keeps, syms, -1).to(torch.int32)
    return tiles.numpy(), qf.to(torch.int32).numpy()


def decode_reference(batch: WalkBatch, stream: np.ndarray, model: StaticModel,
                     n_symbols: int) -> np.ndarray:
    """Full reference decode via the tiles (host scatter)."""
    tiles, _ = walk_reference(batch, stream, model)
    S, T, W = tiles.shape
    g_hi = batch.g_hi.astype(np.int64)
    base = batch.out_base.astype(np.int64)
    t = np.arange(T, dtype=np.int64)
    lane = np.arange(W, dtype=np.int64)
    i = ((g_hi[:, None, None] - t[None, :, None]) * W + lane[None, None, :]
         + base[:, None, None])
    keep = tiles >= 0
    out = np.full(n_symbols, -1, dtype=np.int64)
    out[i[keep]] = tiles[keep]
    if not (out >= 0).all():
        raise RuntimeError("reference tiles did not cover all symbols")
    return out
