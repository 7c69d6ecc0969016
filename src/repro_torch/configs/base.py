"""Architecture config schema + registry.

One module per assigned architecture lives beside this file (``--arch <id>``
resolves through :func:`get_config`); each also provides ``smoke_config()``
— a reduced same-family variant for CPU tests.  The full configs are only
ever instantiated abstractly (ShapeDtypeStruct) by the dry-run.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

ARCH_IDS = (
    "qwen3_4b", "granite_3_2b", "qwen15_32b", "h2o_danube3_4b",
    "seamless_m4t_medium", "grok1_314b", "llama4_scout_17b_a16e",
    "hymba_1_5b", "mamba2_2_7b", "chameleon_34b",
)

# Input-shape cells (LM family): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k":    (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k":  (32_768, 128, "decode"),
    "long_500k":   (524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    swa_window: int = 0          # 0 -> full attention
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # TP-clean SSM projections (z/x/B/C/dt as separate matmuls + split convs)
    # — hillclimb variant; the fused in_proj is the paper-faithful baseline
    # whose sharded-dim split forces per-layer reshards (EXPERIMENTS §Perf).
    ssm_split_proj: bool = False
    # SWA computes only the diagonal band (exact; compute/bytes scale with
    # window not seq) — hillclimb variant, EXPERIMENTS §Perf H2.
    banded_attention: bool = False
    # Expert weights (E, d/data, ff/model) instead of (E, d, ff/(model*data)):
    # per-layer FSDP gather shrinks by the TP degree — hillclimb variant.
    moe_contraction_fsdp: bool = False
    # Hierarchical MoE dispatch: route tokens in N groups sharded over DP so
    # the dispatch gather/scatter stays shard-local — hillclimb variant H1b.
    moe_group_dispatch: int = 0
    # encoder-decoder
    enc_layers: int = 0
    enc_frames: int = 1024       # stub audio frontend: frame-embedding length
    # hybrid (hymba)
    meta_tokens: int = 0
    # distribution profile
    sharding_profile: str = "base"   # base | fsdp
    remat: str = "none"              # none | dots | full
    train_accum: int = 1             # grad-accumulation microbatches (memory)
    # serving
    max_cache: int = 32_768

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 (Megatron-style) so the
        vocab axis shards on any mesh; padded logit columns are masked."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:       # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def sub_quadratic(self) -> bool:
        return bool(self.swa_window) or self.family in ("ssm",)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def runs_shape(self, shape_name: str) -> bool:
        """Cell applicability (skips recorded in DESIGN.md §6)."""
        if shape_name == "long_500k":
            return self.sub_quadratic or self.family == "hybrid"
        return True

    def n_params(self) -> int:
        """Closed-form parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS and memory napkin math."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        mlp = 3 * d * ff
        if self.n_experts:
            mlp = self.n_experts * 3 * d * ff + d * self.n_experts  # + router
        ssm = 0
        if self.ssm_state:
            di, H, N = self.d_inner, self.ssm_heads, self.ssm_state
            ssm = (d * (2 * di + 2 * N + H)   # in_proj (x, z, B, C, dt)
                   + self.ssm_conv * (di + 2 * N)
                   + 2 * H + di * d + di)
        per_layer = {
            "dense": attn + mlp, "vlm": attn + mlp, "audio": attn + mlp,
            "moe": attn + mlp,
            "ssm": ssm,
            "hybrid": attn + mlp + ssm,
            "encdec": attn + mlp,
        }[self.family]
        total = L * per_layer + V * d + d  # + final norm
        if self.is_encdec:
            cross = 2 * (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                         + self.n_heads * hd * d) + mlp  # dec extra cross-attn
            total += self.enc_layers * (attn + mlp)
        if self.meta_tokens:
            total += self.meta_tokens * d
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if not self.n_experts:
            return self.n_params()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        inactive = L * (self.n_experts - self.top_k) * 3 * d * ff
        return self.n_params() - inactive


_REGISTRY: dict[str, "ArchConfig"] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{key}")
    return _REGISTRY[key]


def get_smoke_config(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.smoke_config()


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
