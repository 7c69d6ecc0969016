"""Gradient compression: per-block int8 quantization with error feedback,
in torch.

Counterpart of the JAX package's ``optim/compress.py``:

  * :func:`quantize_int8` / :func:`dequantize_int8` — the per-block
    symmetric quantizer.  The checkpoint's Recoil codec quantizes each float
    leaf with it before entropy coding.  The results are the reference's bit
    for bit on either device: the per-block scale is divided by 127 as a
    device tensor, because CUDA turns a division by a host scalar into a
    multiplication by its reciprocal, which rounds differently.
  * :func:`compress_decompress` / :func:`compress_tree` — one gradient leaf
    (or a tree) plus its error-feedback residual, quantized; with
    ``axis_name=None`` the single-pod path (it still quantizes, for EF
    parity).  Across pods the reference all-gathers the int8 blocks and
    scales over the ``"pod"`` mesh axis inside ``shard_map``; here a pod is
    one device of a list (``runtime.train.make_compressed_crosspod_step``),
    the gather is each pod's int8 blocks and scales moved to every pod's
    device (:func:`gather_mean`), and the mean is the reference's
    ``sum(q * s) / n_pods``, divided by a device tensor as the scale is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .adamw import tree_leaves, tree_map

BLOCK = 256


def quantize_int8(g: torch.Tensor, block: int = BLOCK):
    """Per-block symmetric int8 quantization. Returns (q int8[n, block],
    scales float32[n, 1]); the last block is zero-padded."""
    flat = g.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.div(amax, amax.new_tensor(127.0)) + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    size: int) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return flat.reshape(tuple(shape))


def quantize_with_feedback(g: torch.Tensor, ef: torch.Tensor):
    """One pod's half of :func:`compress_decompress`: add the EF residual,
    quantize, and form the new residual.  Returns ``(q, scale, local_hat,
    new_ef)``; ``ef`` may carry a leading pod-block axis of size 1 (detected
    by ndim), which ``new_ef`` keeps."""
    lead = ef.dim() == g.dim() + 1
    if lead:
        ef = ef[0]
    gq_in = g.to(torch.float32) + ef
    q, scale = quantize_int8(gq_in)
    local_hat = dequantize_int8(q, scale, g.shape, g.numel())
    new_ef = gq_in - local_hat
    return q, scale, local_hat, new_ef[None] if lead else new_ef


def gather_mean(qs, scales, device, shape, dtype) -> torch.Tensor:
    """The pods' mean gradient on ``device``: every pod's int8 blocks and
    scales moved there (the all-gather), dequantized and averaged as the
    reference's ``sum(q_all * s_all, axis=0) / n_pods``."""
    q_all = torch.stack([q.to(device) for q in qs])        # (pods, nb, B)
    s_all = torch.stack([s.to(device) for s in scales])    # (pods, nb, 1)
    acc = torch.sum(q_all.to(torch.float32) * s_all, dim=0)
    # Divided by a device tensor, as the scale is (module docstring).
    acc = torch.div(acc, acc.new_tensor(float(len(qs))))
    size = math.prod(shape)
    return acc.reshape(-1)[:size].reshape(tuple(shape)).to(dtype)


def compress_decompress(g: torch.Tensor, ef: torch.Tensor,
                        axis_name: str | None = None):
    """One gradient leaf: add EF, quantize, return ``(g_hat, new_ef)``.
    With ``axis_name=None`` this is the single-pod identity-communication
    path.  The cross-pod sync needs every pod's blocks at once, so it lives
    in ``runtime.train.make_compressed_crosspod_step`` (built from
    :func:`quantize_with_feedback` and :func:`gather_mean`)."""
    if axis_name is not None:
        raise ValueError(
            "the cross-pod sync runs across a device list: use "
            "runtime.train.make_compressed_crosspod_step")
    _, _, local_hat, new_ef = quantize_with_feedback(g, ef)
    return local_hat.to(g.dtype), new_ef


def init_error_feedback(params, n_pods: int = 0):
    """Float32 zeros like each param; ``n_pods > 0`` adds the leading
    per-pod axis."""
    lead = (n_pods,) if n_pods else ()
    return tree_map(lambda p: torch.zeros(lead + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def compress_tree(grads, ef_tree, axis_name: str | None = None):
    """:func:`compress_decompress` over every gradient leaf; returns
    ``(g_hat tree, new EF tree)``."""
    out = tree_map(lambda g, e: compress_decompress(g, e, axis_name), grads,
                   ef_tree)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def compressed_bytes_ratio(params) -> float:
    """Napkin: payload bytes (int8 + fp32 scale per block) vs fp32."""
    n = sum(p.numel() for p in tree_leaves(params))
    comp = n + (n // BLOCK + 1) * 4
    return comp / (4 * n)
