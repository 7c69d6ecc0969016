"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  FSDP sharding profile (params over
model x data) + full remat: 314B params do not fit TP-only on v5e-256.
[hf:xai-org/grok-1; unverified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok1_314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072, n_experts=8, top_k=2,
    sharding_profile="fsdp", remat="full", train_accum=16))


def smoke_config() -> ArchConfig:
    return ArchConfig(name="grok1_314b_smoke", family="moe", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      n_experts=4, top_k=2, max_cache=128)
