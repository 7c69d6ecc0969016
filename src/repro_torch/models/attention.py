"""Attention: GQA with RoPE, qk-norm, QKV bias, sliding windows.

Counterpart of the JAX package's ``models/attention.py``, written as the
reference's own algorithms so that the port is held to the same numerics:

  * :func:`flash_attention` — blocked online softmax over KV blocks of
    ``block`` positions, a Python loop over the blocks (the reference's
    ``lax.scan``); the (Sq, Sk) score matrix never materializes.  Causal,
    sliding-window and cross (non-causal) masking are position predicates
    on the running block.
  * :func:`banded_flash_attention` — sliding-window self-attention over the
    diagonal band of blocks only.
  * :func:`decode_attention` — a single-token query against a cache laid out
    (B, S, KV, D), masked by absolute position (ring caches need no data
    movement), GQA as a grouped product: the cache is never expanded to H
    heads.

None of the three is a hand-written kernel: the reference computes them
with jnp outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _expand_kv(k, n_heads: int):
    """(B, S, KV, D) -> (B, S, H, D) by group broadcast (GQA)."""
    B, S, KV, D = k.shape
    if KV == n_heads:
        return k
    rep = n_heads // KV
    return k[:, :, :, None, :].expand(B, S, KV, rep, D).reshape(
        B, S, n_heads, D)


def banded_flash_attention(q, k, v, *, window: int, block: int = 1024):
    """Sliding-window attention that only touches the diagonal band.

    q is cut into blocks of ``block >= window``; block i attends to kv
    blocks {i-1, i} only — every other pair is fully masked by the window
    predicate, so skipping them is exact.  Requires self-attention with
    iota positions (the prefill path)."""
    B, Sq, H, D = q.shape
    assert k.shape[1] == Sq
    block = max(block, window)
    nb = -(-Sq // block)
    pad = nb * block - Sq
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    if pad:
        qp = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    else:
        qp = q
    S2 = nb * block
    qb = qp.reshape(B, nb, block, H, D).float()
    kb = k.reshape(B, nb, block, H, D)
    vb = v.reshape(B, nb, block, H, D)
    # kv band for block i = [block i-1 ; block i] (zeros for i == 0)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    kband = torch.cat([kprev, kb], dim=2).float()
    vband = torch.cat([vprev, vb], dim=2).float()
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qb, kband) / np.sqrt(D)
    iota = torch.arange(S2, device=q.device).reshape(nb, block)
    qpos = iota[:, :, None]
    kpos = torch.cat([iota - block, iota], dim=1)[:, None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window) & (kpos >= 0)
    s = torch.where(mask[None, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p, vband)
    out = out.reshape(B, S2, H, D)[:, :Sq]
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_positions=None, kv_positions=None, block: int = 1024,
                    banded_window: bool = False):
    """Online-softmax blocked attention.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D).  Positions default to iota.
    window > 0 masks kv_pos <= q_pos - window (sliding window).
    causal=False with no window is cross/bidirectional attention.
    banded_window=True routes causal SWA self-attention to
    :func:`banded_flash_attention`."""
    if (banded_window and window and causal and q_positions is None
            and kv_positions is None and q.shape[1] == k.shape[1]):
        return banded_flash_attention(q, k, v, window=window, block=block)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Sk, dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(D)
    nblocks = -(-Sk // block)
    pad = nblocks * block - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-(10 ** 9))
    kb = k.reshape(B, nblocks, block, H, D).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nblocks, block, H, D).permute(1, 0, 3, 2, 4)
    pb = kv_positions.reshape(nblocks, block)
    qt = q.transpose(1, 2).float()  # (B, H, Sq, D)

    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for kblk, vblk, pblk in zip(kb, vb, pb):   # (B,H,blk,D) x2, (blk,)
        s = torch.einsum("bhqd,bhkd->bhqk", qt, kblk.float()) * scale
        mask = (pblk[None, :] <= q_positions[:, None] if causal else
                torch.ones((Sq, block), dtype=torch.bool, device=dev))
        if window:
            mask = mask & (pblk[None, :] > q_positions[:, None] - window)
        mask = mask & (pblk >= 0)[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, vblk.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, H, D)


def decode_attention(q, k_cache, v_cache, kv_positions, q_position,
                     k_scale=None, v_scale=None):
    """One-step attention. q: (B, 1, H, D); caches: (B, S, KV, D) in the
    parameter dtype or int8 (+ per-slot scales (B, S, KV, 1));
    kv_positions: (B, S) absolute positions (-1 = empty slot).

    GQA is a grouped product: the cache is never expanded to H heads.  The
    reference accumulates both products in float32 from operands in the
    work dtype (bf16 for an int8 cache, else the cache's) through
    ``preferred_element_type``, which torch's CPU products lack.  Here the
    operands are rounded to the work dtype and then widened to float32 for
    the product: a product of two bf16 values is exact in float32, so these
    are the reference's products and sums in float32, at the cost of a
    float32 copy of one layer's cache slice (a temporary the reference
    avoids).  The int8 scales fold into the scores and probabilities."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    int8 = k_cache.dtype == torch.int8
    work_dt = torch.bfloat16 if int8 else k_cache.dtype
    qg = q.reshape(B, KV, G, D).to(work_dt).float()
    k = k_cache.to(work_dt).float()
    v = v_cache.to(work_dt).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) / np.sqrt(D)
    if k_scale is not None:   # int8: scale factors out of the d-contraction
        s = s * k_scale[..., 0].transpose(1, 2)[:, :, None, :]
    mask = (kv_positions >= 0) & (kv_positions <= q_position[:, None])
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:   # fold v scales into the probabilities
        p = p * v_scale[..., 0].transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", p.to(work_dt).float(), v)
    return out.reshape(B, 1, H, D).to(q.dtype)
