"""Mamba2 SSD (state-space duality, arXiv:2405.21060), chunked dual form, in
torch.

Counterpart of the JAX package's ``models/ssm.py``.  The sequence is split
into chunks of Q tokens.  Within a chunk the recurrence is unrolled into an
attention-like lower-triangular product; across chunks only the (H, P, N)
state is carried, a Python loop over the chunks (the reference's
``lax.scan``).  Decode uses the exact recurrent form on a persistent state.

Everything computes in float32 and casts back, as the reference does.  The
reference's three-operand einsums are written here as pairwise products
whose intermediates are named in the comments: without ``opt_einsum``,
``torch.einsum`` contracts left to right, and the largest intermediate of
that order at full width would be (B, nc, Q, Q, H, P).

Shapes: x (B, S, H, P) heads of the expanded inner dim; B/C (B, S, N) one
shared group; dt (B, S, H) softplus-positive step sizes; A (H,) negative.

None of this is a hand-written kernel: the reference computes it with jnp
outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 128


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches to
    ``x`` above a threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def segsum(log_a):
    """(..., Q) per-step log decay -> (..., Q, Q) lower-tri pairwise sums:
    out[t, s] = sum_{r in (s, t]} log_a[r] for s <= t (else -inf)."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # l_t - l_s
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=log_a.device))
    return torch.where(tri, diff, -torch.inf)


def ssd_chunked(x, dt, A, Bmat, Cmat, h0=None, chunk: int = CHUNK):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H); A: (H,) (negative); Bmat/Cmat: (B, S, N).
    h0: optional initial state (B, H, P, N).  Returns (y (B,S,H,P) in x's
    dtype, h_final (B,H,P,N) float32)."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    f32 = torch.float32
    xc = x.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bmat.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cmat.reshape(Bsz, nc, chunk, N).to(f32)
    log_a = dtc * A.to(f32)[None, None, None, :]         # (B,nc,Q,H) <= 0
    log_a = log_a.transpose(2, 3)                        # (B,nc,H,Q)
    xdt = xc * dtc[..., None]                            # dt-scaled input
    xdt_h = xdt.permute(0, 1, 3, 2, 4)                   # (B,nc,H,Q,P)

    # ---- intra-chunk (dual/attention-like) ----
    Lmat = torch.exp(segsum(log_a))                      # (B,nc,H,Q,Q)
    scores = Cc @ Bc.transpose(-1, -2)                   # (B,nc,Q,Q)
    # (B,nc,H,Q,Q): the scores masked and decayed per head
    mixed = scores[:, :, None] * Lmat
    y_intra = mixed @ xdt_h                              # (B,nc,H,Q,P)
    del mixed, Lmat

    # ---- chunk summary states ----
    csum = torch.cumsum(log_a, dim=-1)                   # (B,nc,H,Q)
    total = csum[..., -1:]                               # (B,nc,H,1)
    decay_to_end = torch.exp(total - csum)               # exp(sum_{r>s})
    # (B,nc,H,P,Q): the decayed inputs, then against B over the chunk
    xdec = (xdt_h * decay_to_end[..., None]).transpose(-1, -2)
    states = xdec @ Bc[:, :, None]                       # (B,nc,H,P,N)
    del xdec

    # ---- inter-chunk state carry (sequential over chunks) ----
    chunk_decay = torch.exp(total[..., 0])               # (B,nc,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                 # (B,nc,H,P,N)

    # ---- inter-chunk contribution ----
    decay_from_start = torch.exp(csum)                   # exp(sum_{r<=t})
    # (B,nc,H,Q,P): C against the carried state, then decayed per step
    y_inter = (Cc[:, :, None] @ h_prev.transpose(-1, -2)) \
        * decay_from_start[..., None]

    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4)       # (B,nc,Q,H,P)
    y = y.reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_decode_step(x, dt, A, Bvec, Cvec, h):
    """Recurrent single step.  x: (B,H,P); dt: (B,H); B/C: (B,N);
    h: (B,H,P,N).  Returns (y (B,H,P) in x's dtype, h' float32)."""
    f32 = torch.float32
    a = torch.exp(dt.to(f32) * A.to(f32)[None, :])                 # (B,H)
    upd = (x * dt[..., None]).to(f32)[..., None] \
        * Bvec.to(f32)[:, None, None, :]                           # (B,H,P,N)
    h_new = h * a[..., None, None] + upd
    y = (h_new @ Cvec.to(f32)[:, None, :, None])[..., 0]           # (B,H,P)
    return y.to(x.dtype), h_new


def causal_conv(x, w, cache=None):
    """Depthwise causal conv1d.  x: (B, S, Cch); w: (K, Cch).
    With cache (B, K-1, Cch): single-step update (S == 1)."""
    K = w.shape[0]
    f32 = torch.float32
    if cache is not None:
        window = torch.cat([cache, x], dim=1)            # (B, K, C)
        y = (window.to(f32) * w.to(f32)).sum(dim=1)[:, None]
        return y.to(x.dtype), window[:, 1:]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = 0
    for i in range(K):
        y = y + xp[:, i:i + S].to(f32) * w[i].to(f32)
    return y.to(x.dtype), xp[:, -(K - 1):] if K > 1 else None
