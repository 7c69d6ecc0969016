"""Per-block int8 quantization, in torch.

Counterpart of the quantizer in the JAX package's ``optim/compress.py``
(``BLOCK``, ``quantize_int8``, ``dequantize_int8``): the checkpoint's Recoil
codec quantizes each float leaf with it before entropy coding.  The results
are the reference's bit for bit on either device: the per-block scale is
divided by 127 as a device tensor, because CUDA turns a division by a host
scalar into a multiplication by its reciprocal, which rounds differently.
The error-feedback compression and its collectives come with the training
slice of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
