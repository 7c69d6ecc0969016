"""AdamW with float32 moments, in torch.

Counterpart of the JAX package's ``optim/adamw.py``.  Moments are plain
trees mirroring the params, in float32; the update runs in float32 and is
cast back to each parameter's dtype.  Leaves are visited in the
reference's order (``jax.tree.flatten`` sorts dict keys), so
:func:`global_norm` sums the leaves' squares in the same order.

``moment_specs`` gives the moments' logical axes for the ZeRO-1 sharding
the sharding rules (``parallel.sharding``) resolve; the dry run reads it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in ``jax.tree.leaves`` order (sorted
    keys, depth first); None leaves are skipped, as jax skips them."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; the result keeps ``tree``'s key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(tree, leaves) -> dict:
    """``tree``'s structure and key order with ``leaves`` (in
    :func:`tree_leaves` order) in place of its leaves."""
    it = iter(leaves)

    def fill(node):
        if not isinstance(node, dict):
            return None if node is None else next(it)
        done = {k: fill(node[k]) for k in sorted(node)}
        return {k: done[k] for k in node}
    return fill(tree)


def init_moments(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(g.to(torch.float32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_adamw(params, grads, opt_state, lr, cfg: AdamWConfig,
                inplace: bool = False):
    """Returns (new_params, new_opt_state, metrics).

    ``inplace=True`` writes the new params and moments into the tensors of
    ``params`` and ``opt_state`` and returns those (the counterpart of a
    donated jit argument): at full size the update then holds one copy of
    the state, not two.  The float32 operations are the same either way."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    # clip / (norm + 1e-9) as a division of tensors: torch computes a
    # number over a tensor as a reciprocal times the number, which rounds
    # differently.
    scale = (torch.clamp(torch.div(gnorm.new_tensor(cfg.grad_clip),
                                   gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    c = count.to(torch.float32)
    bias1 = 1 - torch.pow(cfg.b1, c)
    bias2 = 1 - torch.pow(cfg.b2, c)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        if inplace:
            m_new = m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v_new = v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        else:
            m_new = cfg.b1 * m + (1 - cfg.b1) * g
            v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        del g
        step = (m_new / bias1).div_(torch.sqrt(v_new / bias2).add_(cfg.eps))
        step.add_(cfg.weight_decay * p.to(torch.float32))
        p_new = (p.to(torch.float32) - lr * step).to(p.dtype)
        if inplace:
            p_new = p.copy_(p_new)
        return p_new, m_new, v_new

    new_p, new_m, new_v = {}, {}, {}
    _update(upd, params, grads, opt_state["m"], opt_state["v"],
            new_p, new_m, new_v)
    return new_p, {"m": new_m, "v": new_v, "count": count}, \
        {"grad_norm": gnorm}


def _update(upd, p, g, m, v, out_p, out_m, out_v) -> None:
    """``upd`` over the leaves one at a time, in the reference's order, so
    that one leaf's float32 temporaries are alive at a time."""
    for k in sorted(p):
        if isinstance(p[k], dict):
            out_p[k], out_m[k], out_v[k] = {}, {}, {}
            _update(upd, p[k], g[k], m[k], v[k], out_p[k], out_m[k],
                    out_v[k])
        else:
            out_p[k], out_m[k], out_v[k] = upd(p[k], g[k], m[k], v[k])
    for out in (out_p, out_m, out_v):     # the params' own key order
        for k in p:
            out[k] = out.pop(k)


def moment_specs(param_specs, params_shapes, data_axis_size: int,
                 rules=None):
    """ZeRO-1 sharding: add the "moments" logical axis on the largest dim
    that *resolves* to replicated (given the active rules) and is divisible,
    so moments shard over data on top of the param's own model sharding.
    ``params_shapes`` holds tensors (fake ones too) or shapes; leaves are
    resolved in the reference's order, so ``rules.fallbacks`` grows as
    its does."""
    def one(axes, shape):
        axes = tuple(axes)
        shape = tuple(getattr(shape, "shape", shape))
        resolved = (rules.spec(axes, shape) if rules is not None
                    else tuple(None if a is None else a for a in axes))
        best, best_size = None, 0
        for i, (a, s) in enumerate(zip(tuple(resolved), shape)):
            if a is None and s % data_axis_size == 0 and s > best_size:
                best, best_size = i, s
        if best is None:
            return axes
        return axes[:best] + ("moments",) + axes[best + 1:]

    def walk(specs, shapes):     # jax.tree.map's order: sorted keys
        if not isinstance(specs, dict):
            return one(specs, shapes)
        done = {k: walk(specs[k], shapes[k]) for k in sorted(specs)}
        return {k: done[k] for k in specs}
    return walk(param_specs, params_shapes)
