"""The configurations' content and frequency table, made from the seed.

Bytes are drawn on the device by inverse transform of one ``torch.rand``
stream of a generator seeded with the run's seed, so the same seed gives the
same files on the same kind of device.  The distribution is the paper's
Table 4 ``rand_100`` as the JAX package's ``benchmarks/datasets.py`` makes
it with numpy (``rand_exponential(100)``: ``min(Exp(scale 25.5), 255)``
truncated to a byte), written out as the exact probability of each byte
value.

The frequency table is the benchmark's input, quantized here from those
probabilities and handed to both the program and the reference.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 24          # bytes drawn per torch.rand call


def pmf(dist: dict) -> np.ndarray:
    """Probability of each byte value 0..clip (float64) under ``dist``."""
    clip = int(dist["clip"])
    v = np.arange(clip + 1, dtype=np.float64)
    if dist["kind"] == "exponential":
        s = float(dist["scale"])
        p = np.exp(-v / s) - np.exp(-(v + 1) / s)
        p[-1] = np.exp(-clip / s)
    else:
        raise ValueError(f"unknown distribution {dist['kind']!r}")
    return p


def quantize(p: np.ndarray, n_bits: int) -> np.ndarray:
    """Frequencies summing to 2^n_bits, each symbol of positive probability
    at least 1: floors, then the remainder one by one to the most probable
    symbols (or taken from them, never below 1)."""
    scale = 1 << n_bits
    f = np.floor(p * scale).astype(np.int64)
    f[(p > 0) & (f == 0)] = 1
    order = np.argsort(-p, kind="stable")
    diff = scale - int(f.sum())
    i = 0
    while diff != 0:
        s = order[i % len(order)]
        if diff > 0:
            f[s] += 1
            diff -= 1
        elif f[s] > 1:
            f[s] -= 1
            diff += 1
        i += 1
    return f


def _draw_one(cdf, clip: int, n_bytes: int, gen, device) -> torch.Tensor:
    out = torch.empty(n_bytes, dtype=torch.uint8, device=device)
    for a in range(0, n_bytes, CHUNK):
        b = min(a + CHUNK, n_bytes)
        u = torch.rand(b - a, dtype=torch.float64, generator=gen,
                       device=device)
        out[a:b] = torch.searchsorted(cdf, u, right=True).clamp_(
            max=clip).to(torch.uint8)
    return out


def _source(dist: dict, seed: int, device):
    cdf = torch.as_tensor(np.cumsum(pmf(dist)), dtype=torch.float64,
                          device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return cdf, gen


def draw(dist: dict, n_files: int, n_bytes: int, seed: int,
         device) -> list[torch.Tensor]:
    """``n_files`` files of ``n_bytes`` uint8 symbols on ``device``."""
    cdf, gen = _source(dist, seed, device)
    return [_draw_one(cdf, int(dist["clip"]), n_bytes, gen, device)
            for _ in range(n_files)]
