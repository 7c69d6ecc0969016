"""Shared model primitives, in torch.

Counterpart of the JAX package's ``models/layers.py``.  Parameters are plain
nested dicts of tensors; every leaf is created through :class:`ParamBuilder`,
which draws from an explicit ``torch.Generator`` on an explicit device and
records the leaf's *logical axes* in a parallel specs tree, as the
reference's does (``parallel.sharding`` resolves them for a mesh).

The norms, RoPE and the loss compute in float32 and cast back to the input
dtype, as the reference's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class ParamBuilder:
    """Creates param leaves + mirrors logical axes into a specs tree.
    ``generator`` must live on ``device`` (``torch.randn`` refuses a
    generator of another device)."""

    def __init__(self, generator: torch.Generator, device,
                 dtype=torch.bfloat16):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.specs: dict = {}

    def normal(self, tree: dict, specs: dict, name: str, shape, axes,
               scale: float = None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = (1.0 / np.sqrt(fan_in)) if scale is None else scale
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        tree[name] = x.mul_(scale).to(self.dtype)
        specs[name] = axes
        return tree[name]

    def zeros(self, tree: dict, specs: dict, name: str, shape, axes):
        tree[name] = torch.zeros(shape, dtype=self.dtype, device=self.device)
        specs[name] = axes
        return tree[name]

    def ones(self, tree: dict, specs: dict, name: str, shape, axes):
        tree[name] = torch.ones(shape, dtype=self.dtype, device=self.device)
        specs[name] = axes
        return tree[name]

    def const(self, tree: dict, specs: dict, name: str, value, axes):
        tree[name] = torch.as_tensor(np.asarray(value), device=self.device).to(
            self.dtype)
        specs[name] = axes
        return tree[name]


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def head_rms_norm(x, scale, eps: float = 1e-6):
    """Per-head qk-norm (Qwen3/Chameleon): normalize over head_dim."""
    return rms_norm(x, scale, eps)


def rope(x, positions, theta: float):
    """Rotate-half RoPE. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(theta) * ar / half)
    ang = positions[..., :, None].float() * freqs     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]   # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x):
    """``jax.nn.silu`` as XLA computes it: ``x * logistic(x)``, with the
    logistic expanded to ``1 / (1 + exp(-x))`` and every step rounded to
    ``x``'s dtype.  In bf16 that is five roundings where ``F.silu`` makes
    one, and the two often differ by an ulp, which an SSM block amplifies
    with depth; in float32 both round as the reference's products do."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x, w_gate, w_in, w_out):
    """SwiGLU MLP: silu(x @ w_gate) * (x @ w_in) @ w_out."""
    return (silu(x @ w_gate) * (x @ w_in)) @ w_out


def cross_entropy(logits, labels, ignore: int = -100):
    """Mean next-token CE over non-ignored labels; fp32 softmax."""
    logits = logits.float()
    valid = labels != ignore
    safe = torch.where(valid, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)
