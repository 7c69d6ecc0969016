"""The port's language model: the attention-and-SwiGLU families.

Counterpart of the JAX package's ``models/model.py`` for the families whose
layers are attention plus a SwiGLU MLP, ``dense`` and ``vlm`` (qwen3_4b,
granite_3_2b, qwen15_32b, h2o_danube3_4b, chameleon_34b):

  * params are nested dicts of stacked per-layer tensors, in the
    reference's key order; the layer stack is a Python loop over the
    stacked tensors (the reference's ``lax.scan``);
  * serving: :meth:`LM.prefill` builds the KV cache, :meth:`LM.decode_step`
    advances one token.  Sliding-window configs use ring caches (masking by
    absolute position); ``kv_cache_dtype='int8'`` quantizes the cache per
    slot and head (qwen15_32b's default).

Departures from the reference, all of the serving loop's kind:

  * ``cache["pos"]`` is a host int, so no step reads the position back
    from the device;
  * :meth:`LM.decode_step` writes the new token's keys and values into the
    cache tensors in place and returns the same dict (the reference
    returns a new cache), so a step does not copy the cache;
  * there is no rematerialization, ``shard(...)`` constraint or scan: the
    port runs eagerly on one device, for inference.

The ``moe``, ``ssm``, ``hybrid`` and ``encdec`` families, meta tokens and
encoder frames raise ``NotImplementedError``: they come with a later slice
of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import attention as attn_lib
from .layers import (ParamBuilder, cross_entropy, head_rms_norm, rms_norm,
                     rope, swiglu)

IGNORE = -100
SERVED_FAMILIES = ("dense", "vlm")
_LATER = ("the moe, ssm, hybrid and encdec families and meta tokens come "
          "with the port's next model slice (models/moe.py, models/ssm.py)")


def _not_served(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {_LATER}")


class LM:
    """Builds and runs one attention-and-SwiGLU architecture in torch.

    Methods take the device of the params they are given; :meth:`init`
    takes a ``torch.Generator`` and a device (default ``"cuda"``, which
    raises without a card)."""

    def __init__(self, cfg: ArchConfig, param_dtype=torch.bfloat16,
                 kv_cache_dtype: Optional[str] = None):
        if cfg.family not in SERVED_FAMILIES:
            raise _not_served(f"family {cfg.family!r} ({cfg.name})")
        if cfg.is_encdec:
            raise _not_served(f"an encoder ({cfg.name})")
        if cfg.meta_tokens:
            raise _not_served(f"meta tokens ({cfg.name})")
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
        p["layers"], s["layers"] = self._init_stack(pb, cfg.n_layers, cfg)
        pb.ones(p, s, "final_norm", (cfg.d_model,), ("embed",))
        self._specs = s
        return p

    def param_specs(self):
        """The logical-axes tree of the last :meth:`init`."""
        return self._specs

    def _init_stack(self, pb, L, cfg):
        p, s = {}, {}
        d, hd = cfg.d_model, cfg.head_dim
        H, KV = cfg.n_heads, cfg.n_kv_heads
        pb.ones(p, s, "ln_attn", (L, d), (None, "embed"))
        pb.normal(p, s, "wq", (L, d, H * hd), (None, "embed", "heads"))
        pb.normal(p, s, "wk", (L, d, KV * hd), (None, "embed", "kv_heads"))
        pb.normal(p, s, "wv", (L, d, KV * hd), (None, "embed", "kv_heads"))
        pb.normal(p, s, "wo", (L, H * hd, d), (None, "heads", "embed"))
        if cfg.qkv_bias:
            pb.zeros(p, s, "bq", (L, H * hd), (None, "heads"))
            pb.zeros(p, s, "bk", (L, KV * hd), (None, "kv_heads"))
            pb.zeros(p, s, "bv", (L, KV * hd), (None, "kv_heads"))
        if cfg.qk_norm:
            pb.ones(p, s, "q_norm", (L, hd), (None, "head_dim"))
            pb.ones(p, s, "k_norm", (L, hd), (None, "head_dim"))
        pb.ones(p, s, "ln_mlp", (L, d), (None, "embed"))
        pb.normal(p, s, "w_gate", (L, d, cfg.d_ff), (None, "embed", "ff"))
        pb.normal(p, s, "w_in", (L, d, cfg.d_ff), (None, "embed", "ff"))
        pb.normal(p, s, "w_out", (L, cfg.d_ff, d), (None, "ff", "embed"))
        return p, s

    # ------------------------------------------------------------------
    # forward building blocks (single layer, full sequence)
    # ------------------------------------------------------------------

    def _attn_full(self, lp, x, positions):
        cfg = self.cfg
        B, S, d = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = x @ lp["wq"]
        k = x @ lp["wk"]
        v = x @ lp["wv"]
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, S, KV, hd)
        v = v.reshape(B, S, KV, hd)
        if cfg.qk_norm:
            q = head_rms_norm(q, lp["q_norm"])
            k = head_rms_norm(k, lp["k_norm"])
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = attn_lib.flash_attention(
            q, k, v, causal=True, window=cfg.swa_window,
            banded_window=cfg.banded_attention)
        out = out.reshape(B, S, H * hd)
        return out @ lp["wo"], (k, v)

    def _mlp(self, lp, x):
        return swiglu(x, lp["w_gate"], lp["w_in"], lp["w_out"])

    def _layer(self, lp, x, positions):
        """One decoder layer, full sequence.  Returns (x, (k, v)): the
        layer's keys and values, which the serving cache keeps."""
        a_out, kv = self._attn_full(lp, rms_norm(x, lp["ln_attn"]),
                                    positions)
        x = x + a_out
        x = x + self._mlp(lp, rms_norm(x, lp["ln_mlp"]))
        return x, kv

    # ------------------------------------------------------------------
    # full-sequence forward (prefill / the loss)
    # ------------------------------------------------------------------

    def _embed(self, params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        return params["embed"][tokens.long()]

    def _stack(self, layer_params, x, positions, on_layer=None):
        """The layer loop over the stacked per-layer tensors; ``on_layer(l,
        k, v)`` receives each layer's keys and values."""
        for l in range(self.cfg.n_layers):
            lp = {name: w[l] for name, w in layer_params.items()}
            x, (k, v) = self._layer(lp, x, positions)
            if on_layer is not None:
                on_layer(l, k, v)
        return x

    def logits(self, params, x):
        x = rms_norm(x, params["final_norm"])
        out = x @ params["embed"].T  # tied embeddings
        if self.cfg.padded_vocab > self.cfg.vocab:  # mask padding columns
            out[..., self.cfg.vocab:] = -1e30
        return out

    def forward(self, params, tokens, frames=None):
        """Full forward -> logits (B, S, V)."""
        if frames is not None:
            raise _not_served("an encoder (frames)")
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        x = self._stack(params["layers"], x, positions)
        return self.logits(params, x)

    def loss(self, params, batch):
        """Next-token CE of ``batch["tokens"]`` (forward only)."""
        if batch.get("frames") is not None:
            raise _not_served("an encoder (frames)")
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device)
        logits = self.forward(params, tokens)
        return cross_entropy(logits[:, :-1], tokens[:, 1:])

    # ------------------------------------------------------------------
    # serving: cache init / prefill / decode_step
    # ------------------------------------------------------------------

    def cache_width(self, seq_len: int) -> int:
        cfg = self.cfg
        return seq_len if not cfg.swa_window else min(cfg.swa_window,
                                                      seq_len)

    def init_cache(self, batch: int, seq_len: int, device="cuda"):
        """Zero cache: ``pos`` (a host int), k/v (L, B, W, KV, hd), the
        slots' absolute positions (B, W; -1 = empty) and, for an int8
        cache, per-slot scales (L, B, W, KV, 1)."""
        cfg = self.cfg
        dev = resolve_device(device)
        L = cfg.n_layers
        W = self.cache_width(seq_len)
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        int8 = self.kv_cache_dtype == "int8"
        kv_dt = torch.int8 if int8 else self.param_dtype
        cache = {"pos": 0}
        cache["k"] = torch.zeros((L, batch, W, KV, hd), dtype=kv_dt,
                                 device=dev)
        cache["v"] = torch.zeros((L, batch, W, KV, hd), dtype=kv_dt,
                                 device=dev)
        cache["positions"] = torch.full((batch, W), -1, dtype=torch.int32,
                                        device=dev)
        if int8:
            cache["k_scale"] = torch.zeros((L, batch, W, KV, 1),
                                           dtype=torch.float32, device=dev)
            cache["v_scale"] = torch.zeros((L, batch, W, KV, 1),
                                           dtype=torch.float32, device=dev)
        return cache

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

    def decode_step(self, params, cache, tokens):
        """One token for every sequence.  tokens: (B, 1) -> logits (B, V).
        Writes the cache in place and returns it with ``pos`` advanced."""
        cfg = self.cfg
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens, device=dev)
        B = tokens.shape[0]
        x = self._embed(params, tokens)  # (B, 1, d)
        pos = cache["pos"]
        W = cache["k"].shape[2]
        write_idx = pos % W if cfg.swa_window else pos
        if write_idx >= W:
            raise ValueError(f"the cache holds {W} positions; position {pos} "
                             "does not fit (pass a larger cache_len)")
        q_position = torch.full((B,), pos, dtype=torch.int32, device=dev)
        positions = cache["positions"]
        positions[:, write_idx] = pos
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        int8 = self.kv_cache_dtype == "int8"
        for l in range(cfg.n_layers):
            lp = {name: w[l] for name, w in params["layers"].items()}
            u = rms_norm(x, lp["ln_attn"])
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
            a = attn_lib.decode_attention(
                q, cache["k"][l], cache["v"][l], positions, q_position,
                k_scale=cache["k_scale"][l] if int8 else None,
                v_scale=cache["v_scale"][l] if int8 else None)
            x = x + a.reshape(B, 1, H * hd) @ lp["wo"]
            x = x + self._mlp(lp, rms_norm(x, lp["ln_mlp"]))
        cache["pos"] = pos + 1
        return self.logits(params, x)[:, 0], cache

    def prefill(self, params, tokens, frames=None, cache_len: int = 0):
        """Full-sequence forward that also builds the decode cache.

        ``cache_len`` reserves room for later decode steps (default
        ``max(cfg.max_cache, S)``); sliding-window caches are ring-aligned
        so that position ``p`` lives at slot ``p % W``, the invariant
        :meth:`decode_step` writes with."""
        if frames is not None:
            raise _not_served("an encoder (frames)")
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, S_tot = x.shape[:2]
        dev = x.device
        positions = torch.arange(S_tot, dtype=torch.int32, device=dev)
        cache_len = cache_len or max(cfg.max_cache, S_tot)
        cache = self.init_cache(B, cache_len, dev)
        W = cache["k"].shape[2]
        if cfg.swa_window and W < S_tot:
            # last W entries, ring-aligned: slot(p) == p % W
            shift = S_tot % W

            def on_layer(l, k, v):
                self._store(cache, l, slice(None),
                            torch.roll(k[:, -W:], shift, 1),
                            torch.roll(v[:, -W:], shift, 1))
            cache["positions"][:] = torch.roll(positions[-W:], shift)
        else:
            if S_tot > W:
                raise ValueError(f"a cache of {W} positions cannot hold a "
                                 f"prompt of {S_tot}")

            def on_layer(l, k, v):
                self._store(cache, l, slice(0, S_tot), k, v)
            cache["positions"][:, :S_tot] = positions
        x = self._stack(params["layers"], x, positions, on_layer)
        cache["pos"] = S_tot
        logits = self.logits(params, x[:, -1:])[:, 0]
        return logits, cache
