"""Mixture-of-Experts: token-choice top-k routing with capacity, in torch.

Counterpart of the JAX package's ``models/moe.py``.  Dispatch is by index
(gather and scatter), not a dense one-hot product, so the expert products
cost the active experts' FLOPs times the capacity factor.

Per expert e the slots are filled first-come-first-served (cumsum
position); overflow tokens are dropped (their combine contribution is zero).

Two points where torch and JAX differ, and what the port does about them:

  * **Tie order.**  ``jax.lax.top_k`` breaks ties toward the lower expert
    index; ``torch.topk`` promises no order among equal values.  Router
    logits of a bf16 product tie, so the experts are chosen by a stable
    descending sort (:func:`select_top_k`), lower index first.
  * **Scatters.**  The owner scatter writes each kept slot once; only the
    drop bin (``E*C``) receives duplicate writes, and it is cut away.  The
    combine is a gather of each token's own slot (a zero row for a dropped
    token), which equals the reference's scatter-add into zeros: no float
    atomics, so the kept rows are deterministic on the card.

None of this is a hand-written kernel: the reference computes it with jnp
outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from .layers import silu


def select_top_k(logits, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values by ascending index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _experts(xg, w_gate, w_in, w_out):
    """SwiGLU of every expert over its slots.  xg: (..., E, C, d) ->
    (..., E, C, d)."""
    h = silu(xg @ w_gate) * (xg @ w_in)
    return h @ w_out


def moe_ffn(x, w_router, w_gate, w_in, w_out, *, top_k: int,
            capacity_factor: float, dropless: bool = False,
            groups: int = 0):
    """x: (B, S, d); expert weights: (E, d, ff) / (E, ff, d).

    Returns (B, S, d).  Capacity C = max(1, int(cf * T * top_k / E)) with
    T = B * S.  ``dropless=True`` sets C = T (no token ever dropped), the
    single-token decode path's; ``groups`` routes in that many independent
    blocks (:func:`_grouped_moe_ffn`)."""
    B, S, d = x.shape
    E = w_gate.shape[0]
    if groups:
        return _grouped_moe_ffn(x, w_router, w_gate, w_in, w_out,
                                top_k=top_k, capacity_factor=capacity_factor,
                                groups=groups)
    T = B * S
    C = T if dropless else max(1, int(capacity_factor * T * top_k / E))
    dev = x.device
    xf = x.reshape(T, d)
    logits = (xf @ w_router).float()                        # (T, E)
    top_vals, top_idx = select_top_k(logits, top_k)        # (T, k)
    gates = torch.softmax(top_vals, dim=-1).to(x.dtype)

    y = torch.zeros((T, d), dtype=x.dtype, device=dev)
    token_ids = torch.arange(T, device=dev)
    experts = torch.arange(E, device=dev)
    zero_row = torch.zeros((1, d), dtype=x.dtype, device=dev)
    for j in range(top_k):
        e = top_idx[:, j]                                   # (T,)
        onehot = (e[:, None] == experts[None, :]).to(torch.int64)
        pos = torch.cumsum(onehot, dim=0) * onehot          # 1-indexed slot
        slot = pos.sum(dim=1) - 1                           # (T,)
        flat = torch.where(slot < C, e * C + slot, E * C)   # E*C = drop bin
        # token index per (expert, slot); T marks an empty slot
        owner = torch.full((E * C + 1,), T, dtype=torch.int64,
                           device=dev).scatter_(0, flat, token_ids)[:E * C]
        filled = owner < T
        xg = torch.where(filled[:, None], xf[owner.clamp(max=T - 1)],
                         0).reshape(E, C, d)
        out = _experts(xg, w_gate, w_in, w_out).reshape(E * C, d)
        contrib = torch.cat([out, zero_row])[flat]          # (T, d)
        y = y + contrib * gates[:, j:j + 1]
    return y.reshape(B, S, d)


def _grouped_moe_ffn(x, w_router, w_gate, w_in, w_out, *, top_k: int,
                     capacity_factor: float, groups: int):
    """Hierarchical dispatch: tokens are routed in ``groups`` independent
    blocks of T / groups tokens, each with its own capacity
    C_g = max(1, int(cf * T_g * k / E)) (the same total budget)."""
    B, S, d = x.shape
    E = w_gate.shape[0]
    G = groups
    T = B * S
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    C = max(1, int(capacity_factor * Tg * top_k / E))
    dev = x.device
    xf = x.reshape(G, Tg, d)
    logits = (xf @ w_router).float()                        # (G, Tg, E)
    top_vals, top_idx = select_top_k(logits, top_k)        # (G, Tg, k)
    gates = torch.softmax(top_vals, dim=-1).to(x.dtype)
    token_ids = torch.arange(Tg, device=dev).expand(G, Tg)
    experts = torch.arange(E, device=dev)
    zero_row = torch.zeros((G, 1, d), dtype=x.dtype, device=dev)
    y = torch.zeros((G, Tg, d), dtype=x.dtype, device=dev)
    for j in range(top_k):
        e = top_idx[..., j]                                  # (G, Tg)
        onehot = (e[..., None] == experts).to(torch.int64)
        pos = torch.cumsum(onehot, dim=1) * onehot
        slot = pos.sum(dim=2) - 1                            # (G, Tg)
        flat = torch.where(slot < C, e * C + slot, E * C)
        owner = torch.full((G, E * C + 1), Tg, dtype=torch.int64,
                           device=dev).scatter_(1, flat, token_ids)[:, :E * C]
        xg = torch.gather(xf, 1, owner.clamp(max=Tg - 1)[..., None]
                          .expand(G, E * C, d))
        xg = torch.where((owner < Tg)[..., None], xg, 0).reshape(G, E, C, d)
        out = _experts(xg, w_gate, w_in, w_out).reshape(G, E * C, d)
        contrib = torch.gather(torch.cat([out, zero_row], dim=1), 1,
                               flat[..., None].expand(G, Tg, d))
        y = y + contrib * gates[..., j][..., None]           # token combine
    return y.reshape(B, S, d)


def init_moe(pb, tree, specs, prefix, cfg):
    """Stacked per-layer MoE weights: (L, E, d, ff), with the reference's
    keys and logical axes."""
    L, E, d, ff = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    d_ax = "embed_fsdp" if cfg.moe_contraction_fsdp else "embed"
    ff_ax = "expert_ff_tp" if cfg.moe_contraction_fsdp else "expert_ff"
    pb.normal(tree, specs, f"{prefix}router", (L, d, E),
              (None, "embed", "experts"))
    pb.normal(tree, specs, f"{prefix}gate", (L, E, d, ff),
              (None, "experts", d_ax, ff_ax))
    pb.normal(tree, specs, f"{prefix}in", (L, E, d, ff),
              (None, "experts", d_ax, ff_ax))
    pb.normal(tree, specs, f"{prefix}out", (L, E, ff, d),
              (None, "experts", ff_ax, d_ax))
