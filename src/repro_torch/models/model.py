"""The port's language model: every family of the JAX package's ``LM``.

Counterpart of the JAX package's ``models/model.py``:

  * params are nested dicts of stacked per-layer tensors, in the
    reference's key order; the layer stack is a Python loop over the
    stacked tensors (the reference's ``lax.scan``);
  * families compose from the same primitives: ``dense``/``vlm``/``audio``
    are attention plus SwiGLU; ``moe`` swaps the FFN (``moe.py``); ``ssm``
    is Mamba2 SSD blocks (``ssm.py``); ``hybrid`` runs attention and SSM
    paths in parallel (Hymba) plus SwiGLU, with learned meta tokens ahead
    of the prompt; ``encdec`` is an encoder stack over frame embeddings and
    a decoder with cross-attention (Seamless's text decoder; the audio
    frontend is a stub, as in the reference);
  * serving: :meth:`LM.prefill` builds the KV, SSM and cross caches,
    :meth:`LM.decode_step` advances one token.  Sliding-window configs use
    ring caches (masking by absolute position); ``kv_cache_dtype='int8'``
    quantizes the cache per slot and head (qwen15_32b's default).

Training: :meth:`LM.loss` is differentiable for every family and honours
``cfg.remat`` as the reference's layer scan does: ``"none"`` recomputes
nothing, ``"full"`` runs each layer under ``torch.utils.checkpoint``, and
``"dots"`` keeps only the outputs of products with no batch dimension
(``x @ W``, ``aten.mm``/``aten.addmm``) and recomputes the rest, the
attention's and the experts' batched products included (the counterpart of
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``).  As in the
reference, self- and cross-attention run under a checkpoint of their own
whatever the policy, so no KV block's scores are kept for backward.  A
layer loop takes each stacked leaf apart with one ``torch.unbind`` a
forward, whose backward stacks the layers' gradients once (indexing
``w[l]`` per layer would add a zero tensor of the whole stack per layer).

Departures from the reference, all of the serving loop's kind:

  * ``cache["pos"]`` is a host int, so no step reads the position back
    from the device;
  * :meth:`LM.decode_step` writes the new token's keys and values, the SSM
    state and the conv tails into the cache tensors in place and returns
    the same dict (the reference returns a new cache), so a step does not
    copy the cache;
  * :meth:`LM.prefill` takes each decoder layer's cross-attention keys and
    values from the layer's own cross-attention (the reference computes the
    same products again in a second scan);
  * there is no ``shard(...)`` constraint or scan: the port runs eagerly on
    one device.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (ParamBuilder, cross_entropy, head_rms_norm, rms_norm,
                     rope, silu, swiglu)

IGNORE = -100
FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid", "encdec")
# The families whose layers hold attention (every one but ``ssm``).
_ATTN_FAMILIES = ("dense", "vlm", "audio", "moe", "hybrid", "encdec")
# Products with no batch dimension: x @ W with a 2-D weight (torch folds the
# leading axes of x into one, so they reach the dispatcher as mm).
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of products
    with no batch dimension, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_KW = {
    "full": {},
    "dots": {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)},
}


def _remat(fn, policy: str = "full"):
    """``fn`` under a rematerialization policy while autograd records
    (under ``no_grad`` there is nothing to keep or recompute)."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             **_REMAT_KW[policy])


def _per_layer(stacked: dict) -> list:
    """Each layer's dict of slices of the stacked leaves, by one
    ``torch.unbind`` a leaf."""
    cols = {name: torch.unbind(w) for name, w in stacked.items()}
    n = len(next(iter(cols.values())))
    return [{name: c[l] for name, c in cols.items()} for l in range(n)]


class LM:
    """Builds and runs one architecture in torch.

    Methods take the device of the params they are given; :meth:`init`
    takes a ``torch.Generator`` and a device (default ``"cuda"``, which
    raises without a card)."""

    def __init__(self, cfg: ArchConfig, param_dtype=torch.bfloat16,
                 kv_cache_dtype: Optional[str] = None):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.kv_cache_dtype = kv_cache_dtype or (
            "int8" if cfg.name.startswith("qwen15_32b") else "bf16")
        self._specs: Optional[dict] = None

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def init(self, generator: torch.Generator, device="cuda"):
        cfg = self.cfg
        pb = ParamBuilder(generator, resolve_device(device), self.param_dtype)
        p, s = {}, {}
        pb.normal(p, s, "embed", (cfg.padded_vocab, cfg.d_model),
                  ("vocab", "embed"), scale=0.02)
        if cfg.meta_tokens:
            pb.normal(p, s, "meta", (cfg.meta_tokens, cfg.d_model),
                      (None, "embed"), scale=0.02)
        p["layers"], s["layers"] = self._init_stack(pb, cfg.n_layers, cfg,
                                                    decoder=True)
        if cfg.is_encdec:
            p["enc_layers"], s["enc_layers"] = self._init_stack(
                pb, cfg.enc_layers, cfg, decoder=False)
            pb.ones(p, s, "enc_final_norm", (cfg.d_model,), ("embed",))
        pb.ones(p, s, "final_norm", (cfg.d_model,), ("embed",))
        self._specs = s
        return p

    def param_specs(self):
        """The params' logical-axes tree (built over fake tensors when
        :meth:`init` has not run, as the reference builds it abstractly)."""
        if self._specs is None:
            from torch._subclasses.fake_tensor import FakeTensorMode
            with FakeTensorMode():
                self.init(torch.Generator(), device="cpu")
        return self._specs

    def _init_stack(self, pb, L, cfg, *, decoder: bool):
        p, s = {}, {}
        d, hd = cfg.d_model, cfg.head_dim
        H, KV = cfg.n_heads, cfg.n_kv_heads
        has_attn = cfg.family != "ssm"
        has_ssm = cfg.family in ("ssm", "hybrid")
        if has_attn:
            pb.ones(p, s, "ln_attn", (L, d), (None, "embed"))
            pb.normal(p, s, "wq", (L, d, H * hd), (None, "embed", "heads"))
            pb.normal(p, s, "wk", (L, d, KV * hd),
                      (None, "embed", "kv_heads"))
            pb.normal(p, s, "wv", (L, d, KV * hd),
                      (None, "embed", "kv_heads"))
            pb.normal(p, s, "wo", (L, H * hd, d), (None, "heads", "embed"))
            if cfg.qkv_bias:
                pb.zeros(p, s, "bq", (L, H * hd), (None, "heads"))
                pb.zeros(p, s, "bk", (L, KV * hd), (None, "kv_heads"))
                pb.zeros(p, s, "bv", (L, KV * hd), (None, "kv_heads"))
            if cfg.qk_norm:
                pb.ones(p, s, "q_norm", (L, hd), (None, "head_dim"))
                pb.ones(p, s, "k_norm", (L, hd), (None, "head_dim"))
            if decoder and cfg.is_encdec:
                pb.ones(p, s, "ln_cross", (L, d), (None, "embed"))
                pb.normal(p, s, "cwq", (L, d, H * hd),
                          (None, "embed", "heads"))
                pb.normal(p, s, "cwk", (L, d, KV * hd),
                          (None, "embed", "kv_heads"))
                pb.normal(p, s, "cwv", (L, d, KV * hd),
                          (None, "embed", "kv_heads"))
                pb.normal(p, s, "cwo", (L, H * hd, d),
                          (None, "heads", "embed"))
        if has_ssm:
            di, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            K = cfg.ssm_conv
            pb.ones(p, s, "ln_ssm", (L, d), (None, "embed"))
            if cfg.ssm_split_proj:
                pb.normal(p, s, "ssm_wz", (L, d, di),
                          (None, "embed", "ssm_inner"))
                pb.normal(p, s, "ssm_wx", (L, d, di),
                          (None, "embed", "ssm_inner"))
                pb.normal(p, s, "ssm_wbc", (L, d, 2 * N),
                          (None, "embed", None))
                pb.normal(p, s, "ssm_wdt", (L, d, Hs),
                          (None, "embed", "ssm_heads"))
                pb.normal(p, s, "conv_x_w", (L, K, di),
                          (None, None, "ssm_inner"), scale=0.5)
                pb.normal(p, s, "conv_bc_w", (L, K, 2 * N),
                          (None, None, None), scale=0.5)
            else:
                pb.normal(p, s, "ssm_in", (L, d, 2 * di + 2 * N + Hs),
                          (None, "embed", "ssm_inner"))
                pb.normal(p, s, "conv_w", (L, K, di + 2 * N),
                          (None, None, "ssm_inner"), scale=0.5)
            pb.const(p, s, "A_log", np.broadcast_to(
                np.log(np.arange(1, Hs + 1, dtype=np.float32)),
                (L, Hs)).copy(), (None, None))
            pb.zeros(p, s, "D", (L, Hs), (None, None))
            pb.zeros(p, s, "dt_bias", (L, Hs), (None, None))
            pb.ones(p, s, "ssm_norm", (L, di), (None, "ssm_inner"))
            pb.normal(p, s, "ssm_out", (L, di, d),
                      (None, "ssm_inner", "embed"))
        if cfg.family == "hybrid":
            pb.ones(p, s, "mix_attn", (L, d), (None, "embed"))
            pb.ones(p, s, "mix_ssm", (L, d), (None, "embed"))
        if cfg.family == "moe":
            pb.ones(p, s, "ln_mlp", (L, d), (None, "embed"))
            moe_lib.init_moe(pb, p, s, "moe_", cfg)
        elif cfg.d_ff:
            pb.ones(p, s, "ln_mlp", (L, d), (None, "embed"))
            pb.normal(p, s, "w_gate", (L, d, cfg.d_ff), (None, "embed", "ff"))
            pb.normal(p, s, "w_in", (L, d, cfg.d_ff), (None, "embed", "ff"))
            pb.normal(p, s, "w_out", (L, cfg.d_ff, d), (None, "ff", "embed"))
        return p, s

    # ------------------------------------------------------------------
    # forward building blocks (single layer, full sequence)
    # ------------------------------------------------------------------

    def _attn_full(self, lp, x, positions, *, causal=True, memory=None,
                   prefix=""):
        """Self-attention (``memory=None``) or cross-attention over
        ``memory`` with the ``prefix`` projections (no RoPE, bias or
        qk-norm; non-causal; key positions ``arange(F)``).  Returns
        (out, (k, v))."""
        cfg = self.cfg
        B, S, d = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        src = x if memory is None else memory
        q = x @ lp[prefix + "wq"]
        k = src @ lp[prefix + "wk"]
        v = src @ lp[prefix + "wv"]
        if cfg.qkv_bias and not prefix:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, src.shape[1], KV, hd)
        v = v.reshape(B, src.shape[1], KV, hd)
        if cfg.qk_norm and not prefix:
            q = head_rms_norm(q, lp["q_norm"])
            k = head_rms_norm(k, lp["k_norm"])
        if memory is None:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            out = _remat(attn_lib.flash_attention)(
                q, k, v, causal=causal, window=cfg.swa_window,
                banded_window=cfg.banded_attention)
        else:
            out = _remat(attn_lib.flash_attention)(
                q, k, v, causal=False, q_positions=positions,
                kv_positions=torch.arange(src.shape[1], dtype=torch.int32,
                                          device=x.device))
        out = out.reshape(B, S, H * hd)
        return out @ lp[prefix + "wo"], (k, v)

    def _ssm_in(self, lp, u, conv_cache):
        """The SSM block's input projections and causal convs, over the
        sequence (``conv_cache=None``) or one step from the cached conv
        tails.  Returns (z, xs, Bm, Cm, dt, conv_new)."""
        cfg = self.cfg
        di, N = cfg.d_inner, cfg.ssm_state
        if cfg.ssm_split_proj:
            z = u @ lp["ssm_wz"]
            xin = u @ lp["ssm_wx"]
            bc = u @ lp["ssm_wbc"]
            dt = u @ lp["ssm_wdt"]
            cx, cbc = (None, None) if conv_cache is None else conv_cache
            xin, conv_x = ssm_lib.causal_conv(xin, lp["conv_x_w"], cx)
            bc, conv_b = ssm_lib.causal_conv(bc, lp["conv_bc_w"], cbc)
            xs = silu(xin)
            bc = silu(bc)
            Bm, Cm = bc[..., :N], bc[..., N:]
            conv_new = (conv_x, conv_b)
        else:
            proj = u @ lp["ssm_in"]
            z = proj[..., :di]
            xbc = proj[..., di:2 * di + 2 * N]
            dt = proj[..., 2 * di + 2 * N:]
            xbc, conv_new = ssm_lib.causal_conv(xbc, lp["conv_w"],
                                                conv_cache)
            xbc = silu(xbc)
            xs, Bm, Cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
        return z, xs, Bm, Cm, dt, conv_new

    def _ssm_out(self, lp, y, xs, z, D_shape):
        """The skip term, the gated norm and the output projection."""
        y = y + xs * lp["D"].to(y.dtype).reshape(D_shape)
        y = y.reshape(*z.shape)
        y = rms_norm(y, lp["ssm_norm"]) * silu(z)
        return y @ lp["ssm_out"]

    def _ssm_full(self, lp, u, h0=None, conv_cache=None):
        cfg = self.cfg
        B, S, _ = u.shape
        z, xs, Bm, Cm, dt, conv_new = self._ssm_in(lp, u, conv_cache)
        xs = xs.reshape(B, S, cfg.ssm_heads, cfg.ssm_head_dim)
        dt = ssm_lib.softplus(dt.float() + lp["dt_bias"].float())
        A = -torch.exp(lp["A_log"].float())
        y, h_last = ssm_lib.ssd_chunked(xs, dt, A, Bm, Cm, h0=h0)
        out = self._ssm_out(lp, y, xs, z, (1, 1, -1, 1))
        return out, (h_last, conv_new)

    def _ssm_decode(self, lp, u, ssm_h, conv_cache):
        """One SSM step.  u: (B, 1, d) -> ((B, 1, d), (h_new, conv_new))."""
        cfg = self.cfg
        B = u.shape[0]
        z, xs, Bm, Cm, dt, conv_new = self._ssm_in(lp, u, conv_cache)
        z, xs, Bm, Cm, dt = (t[:, 0] for t in (z, xs, Bm, Cm, dt))
        xs = xs.reshape(B, cfg.ssm_heads, cfg.ssm_head_dim)
        dt = ssm_lib.softplus(dt.float() + lp["dt_bias"].float())
        A = -torch.exp(lp["A_log"].float())
        y, h_new = ssm_lib.ssd_decode_step(xs, dt, A, Bm, Cm, ssm_h)
        out = self._ssm_out(lp, y, xs, z, (1, -1, 1))
        return out[:, None], (h_new, conv_new)

    def _conv_cache(self, cache, l):
        """Layer ``l``'s cached conv tails, as :meth:`_ssm_in` takes them."""
        if self.cfg.ssm_split_proj:
            return cache["conv_x"][l], cache["conv_bc"][l]
        return cache["conv"][l]

    def _store_conv(self, cache: dict, l: int, conv_new) -> None:
        """Write layer ``l``'s conv tails in place, in the cache's dtype."""
        if self.cfg.ssm_split_proj:
            cache["conv_x"][l] = conv_new[0]
            cache["conv_bc"][l] = conv_new[1]
        else:
            cache["conv"][l] = conv_new

    def _mlp(self, lp, x, dropless: bool = False):
        cfg = self.cfg
        if cfg.family == "moe":
            return moe_lib.moe_ffn(x, lp["moe_router"], lp["moe_gate"],
                                   lp["moe_in"], lp["moe_out"],
                                   top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor,
                                   dropless=dropless,
                                   groups=0 if dropless else
                                   cfg.moe_group_dispatch)
        return swiglu(x, lp["w_gate"], lp["w_in"], lp["w_out"])

    def _fuse(self, lp, a_out, s_out):
        """Hymba's fusion of the attention and SSM paths."""
        ones_d = torch.ones_like(lp["ln_attn"])
        return 0.5 * (lp["mix_attn"] * rms_norm(a_out, ones_d)
                      + lp["mix_ssm"] * rms_norm(s_out, ones_d))

    def _layer(self, lp, x, positions, memory=None):
        """One decoder layer, full sequence.  Returns (x, aux): what the
        serving cache needs, ``{"kv": (k, v)}`` and/or ``{"ssm": (h_last,
        conv_tail)}``, and ``{"cross": (k, v)}`` with ``memory``."""
        cfg = self.cfg
        aux = {}
        if cfg.family == "ssm":
            y, aux["ssm"] = self._ssm_full(lp, rms_norm(x, lp["ln_ssm"]))
            x = x + y
        elif cfg.family == "hybrid":
            u = rms_norm(x, lp["ln_attn"])
            a_out, aux["kv"] = self._attn_full(lp, u, positions)
            s_out, aux["ssm"] = self._ssm_full(lp, u)
            x = x + self._fuse(lp, a_out, s_out)
            x = x + self._mlp(lp, rms_norm(x, lp["ln_mlp"]))
        else:
            a_out, aux["kv"] = self._attn_full(lp, rms_norm(x, lp["ln_attn"]),
                                               positions)
            x = x + a_out
            if memory is not None:
                c_out, aux["cross"] = self._attn_full(
                    lp, rms_norm(x, lp["ln_cross"]), positions,
                    memory=memory, prefix="c")
                x = x + c_out
            x = x + self._mlp(lp, rms_norm(x, lp["ln_mlp"]))
        return x, aux

    # ------------------------------------------------------------------
    # full-sequence forward (prefill / the loss)
    # ------------------------------------------------------------------

    def _embed(self, params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        x = params["embed"][tokens.long()]
        if self.cfg.meta_tokens:
            meta = params["meta"][None].expand(
                (tokens.shape[0],) + tuple(params["meta"].shape))
            x = torch.cat([meta, x.to(meta.dtype)], dim=1)
        return x

    def _stack(self, layer_params, x, positions, memory=None,
               on_layer=None):
        """The layer loop over the stacked per-layer tensors; ``on_layer(l,
        aux)`` receives each layer's cache entries (:meth:`_layer`).
        Without ``on_layer`` each layer runs under the remat policy."""
        body = _remat(lambda lp, xx: self._layer(lp, xx, positions,
                                                 memory=memory)[0],
                      self.cfg.remat)
        for l, lp in enumerate(_per_layer(layer_params)):
            if on_layer is None:
                x = body(lp, x)
            else:
                x, aux = self._layer(lp, x, positions, memory=memory)
                on_layer(l, aux)
        return x

    def _frames(self, params, frames):
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: pass "
                             "frames (B, F, d_model)")
        dev = params["embed"].device
        if torch.is_tensor(frames):
            return frames.to(dev)
        return torch.as_tensor(np.asarray(frames), device=dev)

    def _encode(self, params, frames):
        """Encoder stack over stub frame embeddings (B, F, d)."""
        x = self._frames(params, frames).to(self.param_dtype)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)

        def body(lp, xx):
            a, _ = self._attn_full(lp, rms_norm(xx, lp["ln_attn"]),
                                   positions, causal=False)
            xx = xx + a
            return xx + self._mlp(lp, rms_norm(xx, lp["ln_mlp"]))
        body = _remat(body, self.cfg.remat)
        for lp in _per_layer(params["enc_layers"]):
            x = body(lp, x)
        return rms_norm(x, params["enc_final_norm"])

    def logits(self, params, x):
        x = rms_norm(x, params["final_norm"])
        out = x @ params["embed"].T  # tied embeddings
        if self.cfg.padded_vocab > self.cfg.vocab:  # mask padding columns
            out[..., self.cfg.vocab:] = -1e30
        return out

    def forward(self, params, tokens, frames=None):
        """Full forward -> logits (B, S(+meta), V)."""
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        memory = (self._encode(params, frames) if self.cfg.is_encdec
                  else None)
        x = self._stack(params["layers"], x, positions, memory=memory)
        return self.logits(params, x)

    def loss(self, params, batch):
        """Next-token CE of ``batch["tokens"]`` (and ``batch["frames"]`` for
        an encoder-decoder); hymba's meta-token positions are dropped before
        the shift.  Differentiable in the params."""
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device)
        logits = self.forward(params, tokens, frames=batch.get("frames"))
        if self.cfg.meta_tokens:
            logits = logits[:, self.cfg.meta_tokens:]
        return cross_entropy(logits[:, :-1], tokens[:, 1:])

    # ------------------------------------------------------------------
    # serving: cache init / prefill / decode_step
    # ------------------------------------------------------------------

    def cache_width(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.family == "ssm":
            return 0
        return seq_len if not cfg.swa_window else min(cfg.swa_window,
                                                      seq_len)

    def init_cache(self, batch: int, seq_len: int, device="cuda"):
        """Zero cache: ``pos`` (a host int); with attention, k/v (L, B, W,
        KV, hd), the slots' absolute positions (B, W; -1 = empty) and, for
        an int8 cache, per-slot scales (L, B, W, KV, 1); with an SSM, its
        state (L, B, H, P, N) in float32 and the conv tails (L, B, K-1, C);
        with an encoder, the cross keys and values (L, B, F, KV, hd)."""
        cfg = self.cfg
        dev = resolve_device(device)
        L = cfg.n_layers
        W = self.cache_width(seq_len)
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        int8 = self.kv_cache_dtype == "int8"
        pdt = self.param_dtype

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
        cache = {"pos": 0}
        if W:
            kv_dt = torch.int8 if int8 else pdt
            cache["k"] = zeros((L, batch, W, KV, hd), kv_dt)
            cache["v"] = zeros((L, batch, W, KV, hd), kv_dt)
            cache["positions"] = torch.full((batch, W), -1, dtype=torch.int32,
                                            device=dev)
            if int8:
                cache["k_scale"] = zeros((L, batch, W, KV, 1), torch.float32)
                cache["v_scale"] = zeros((L, batch, W, KV, 1), torch.float32)
        if cfg.ssm_state:
            K1 = cfg.ssm_conv - 1
            cache["ssm_h"] = zeros((L, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state), torch.float32)
            if cfg.ssm_split_proj:
                cache["conv_x"] = zeros((L, batch, K1, cfg.d_inner), pdt)
                cache["conv_bc"] = zeros((L, batch, K1, 2 * cfg.ssm_state),
                                         pdt)
            else:
                cache["conv"] = zeros(
                    (L, batch, K1, cfg.d_inner + 2 * cfg.ssm_state), pdt)
        if cfg.is_encdec:
            F = cfg.enc_frames
            cache["cross_k"] = zeros((L, batch, F, KV, hd), pdt)
            cache["cross_v"] = zeros((L, batch, F, KV, hd), pdt)
        return cache

    def cache_specs(self):
        """Logical axes per cache leaf (mirrors :meth:`init_cache`)."""
        specs = {"pos": ()}
        cfg = self.cfg
        if self.cache_width(1 << 30):
            specs.update(k=(None, "batch", "kv_seq", "kv_heads", "head_dim"),
                         v=(None, "batch", "kv_seq", "kv_heads", "head_dim"),
                         positions=("batch", "kv_seq"))
            if self.kv_cache_dtype == "int8":
                specs.update(
                    k_scale=(None, "batch", "kv_seq", "kv_heads", None),
                    v_scale=(None, "batch", "kv_seq", "kv_heads", None))
        if cfg.ssm_state:
            specs.update(ssm_h=(None, "batch", None, "ssm_inner", None))
            if cfg.ssm_split_proj:
                specs.update(conv_x=(None, "batch", None, "ssm_inner"),
                             conv_bc=(None, "batch", None, None))
            else:
                specs.update(conv=(None, "batch", None, "ssm_inner"))
        if cfg.is_encdec:
            specs.update(
                cross_k=(None, "batch", "frames", "kv_heads", "head_dim"),
                cross_v=(None, "batch", "frames", "kv_heads", "head_dim"))
        return specs

    def _quant(self, x):
        if self.kv_cache_dtype != "int8":
            return x.to(self.param_dtype), None
        xf = x.float()
        # Divided by a device tensor, not a Python number: CUDA turns a
        # division by a host scalar into a multiplication by its reciprocal.
        scale = torch.div(xf.abs().amax(dim=-1, keepdim=True),
                          xf.new_tensor(127.0)) + 1e-8
        q = torch.clamp(torch.round(xf / scale), -127, 127)
        return q.to(torch.int8), scale

    def _dequant(self, q, scale):
        if scale is None:
            return q
        return q.float() * scale

    def _store(self, cache, l, slots, k, v):
        """Quantize and write layer ``l``'s keys and values (B, n, KV, hd)
        at cache ``slots`` (a slice or an index) in place."""
        kq, ks = self._quant(k)
        vq, vs = self._quant(v)
        cache["k"][l, :, slots] = kq
        cache["v"][l, :, slots] = vq
        if ks is not None:
            cache["k_scale"][l, :, slots] = ks
            cache["v_scale"][l, :, slots] = vs

    def _attn_decode(self, lp, u, cache, l, write_idx, q_position):
        """One token's self-attention against layer ``l``'s cache, after
        writing its keys and values at ``write_idx``.  -> (B, 1, d)."""
        cfg = self.cfg
        B = u.shape[0]
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (u @ lp["wq"]).reshape(B, 1, H, hd)
        k = (u @ lp["wk"]).reshape(B, 1, KV, hd)
        v = (u @ lp["wv"]).reshape(B, 1, KV, hd)
        if cfg.qkv_bias:
            q = q + lp["bq"].reshape(1, 1, H, hd)
            k = k + lp["bk"].reshape(1, 1, KV, hd)
            v = v + lp["bv"].reshape(1, 1, KV, hd)
        if cfg.qk_norm:
            q = head_rms_norm(q, lp["q_norm"])
            k = head_rms_norm(k, lp["k_norm"])
        q = rope(q, q_position[:, None], cfg.rope_theta)
        k = rope(k, q_position[:, None], cfg.rope_theta)
        self._store(cache, l, write_idx, k[:, 0], v[:, 0])
        int8 = self.kv_cache_dtype == "int8"
        a = attn_lib.decode_attention(
            q, cache["k"][l], cache["v"][l], cache["positions"], q_position,
            k_scale=cache["k_scale"][l] if int8 else None,
            v_scale=cache["v_scale"][l] if int8 else None)
        return a.reshape(B, 1, H * hd) @ lp["wo"]

    def _cross_decode(self, lp, x, cache, l):
        """One token's cross-attention against layer ``l``'s cross cache:
        every frame is visible (query position 1 << 30)."""
        cfg = self.cfg
        B = x.shape[0]
        H, hd = cfg.n_heads, cfg.head_dim
        u = rms_norm(x, lp["ln_cross"])
        qc = (u @ lp["cwq"]).reshape(B, 1, H, hd)
        F = cache["cross_k"].shape[2]
        mem_pos = torch.arange(F, dtype=torch.int32,
                               device=x.device).expand(B, F)
        c = attn_lib.decode_attention(
            qc, cache["cross_k"][l], cache["cross_v"][l], mem_pos,
            torch.full((B,), 1 << 30, dtype=torch.int32, device=x.device))
        return c.reshape(B, 1, H * hd) @ lp["cwo"]

    def decode_step(self, params, cache, tokens):
        """One token for every sequence.  tokens: (B, 1) -> logits (B, V).
        Writes the cache in place and returns it with ``pos`` advanced."""
        cfg = self.cfg
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens, device=dev)
        B = tokens.shape[0]
        x = params["embed"][tokens.long()]  # (B, 1, d)
        pos = cache["pos"]
        W = cache["k"].shape[2] if "k" in cache else 0
        q_position = torch.full((B,), pos, dtype=torch.int32, device=dev)
        write_idx = None
        if W:
            write_idx = pos % W if cfg.swa_window else pos
            if write_idx >= W:
                raise ValueError(f"the cache holds {W} positions; position "
                                 f"{pos} does not fit (pass a larger "
                                 "cache_len)")
            cache["positions"][:, write_idx] = pos
        for l, lp in enumerate(_per_layer(params["layers"])):
            if cfg.family in _ATTN_FAMILIES:
                u = rms_norm(x, lp["ln_attn"])
                a_out = self._attn_decode(lp, u, cache, l, write_idx,
                                          q_position)
                if cfg.family == "hybrid":
                    s_out, (h_new, conv_new) = self._ssm_decode(
                        lp, u, cache["ssm_h"][l], self._conv_cache(cache, l))
                    cache["ssm_h"][l] = h_new
                    self._store_conv(cache, l, conv_new)
                    x = x + self._fuse(lp, a_out, s_out)
                else:
                    x = x + a_out
                if cfg.is_encdec:
                    x = x + self._cross_decode(lp, x, cache, l)
                x = x + self._mlp(lp, rms_norm(x, lp["ln_mlp"]),
                                  dropless=True)
            else:  # pure ssm
                u = rms_norm(x, lp["ln_ssm"])
                y, (h_new, conv_new) = self._ssm_decode(
                    lp, u, cache["ssm_h"][l], self._conv_cache(cache, l))
                cache["ssm_h"][l] = h_new
                self._store_conv(cache, l, conv_new)
                x = x + y
        cache["pos"] = pos + 1
        return self.logits(params, x)[:, 0], cache

    def prefill(self, params, tokens, frames=None, cache_len: int = 0):
        """Full-sequence forward that also builds the decode cache.

        ``cache_len`` reserves room for later decode steps (default
        ``max(cfg.max_cache, S_tot)``, S_tot counting meta tokens);
        sliding-window caches are ring-aligned so that position ``p`` lives
        at slot ``p % W``, the invariant :meth:`decode_step` writes with.
        SSM layers leave their last state and conv tails (in the parameter
        dtype), an encoder-decoder every layer's cross keys and values."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, S_tot = x.shape[:2]
        dev = x.device
        positions = torch.arange(S_tot, dtype=torch.int32, device=dev)
        memory = self._encode(params, frames) if cfg.is_encdec else None
        cache_len = cache_len or max(cfg.max_cache, S_tot)
        cache = self.init_cache(B, cache_len, dev)
        W = cache["k"].shape[2] if "k" in cache else 0
        ring = bool(cfg.swa_window) and 0 < W < S_tot
        if W and not ring and S_tot > W:
            raise ValueError(f"a cache of {W} positions cannot hold a "
                             f"prompt of {S_tot}")
        shift = S_tot % W if ring else 0

        def on_layer(l, aux):
            if "kv" in aux:
                k, v = aux["kv"]
                if ring:   # last W entries, ring-aligned: slot(p) == p % W
                    self._store(cache, l, slice(None),
                                torch.roll(k[:, -W:], shift, 1),
                                torch.roll(v[:, -W:], shift, 1))
                else:
                    self._store(cache, l, slice(0, S_tot), k, v)
            if "ssm" in aux:
                h_last, conv_tail = aux["ssm"]
                cache["ssm_h"][l] = h_last
                self._store_conv(cache, l, conv_tail)
            if "cross" in aux:
                cache["cross_k"][l], cache["cross_v"][l] = aux["cross"]
        if W:
            if ring:
                cache["positions"][:] = torch.roll(positions[-W:], shift)
            else:
                cache["positions"][:, :S_tot] = positions
        x = self._stack(params["layers"], x, positions, memory=memory,
                        on_layer=on_layer)
        cache["pos"] = S_tot
        logits = self.logits(params, x[:, -1:])[:, 0]
        return logits, cache
