"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1, early fusion.  FSDP profile (~100B total
params). [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4_scout_17b_a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
    n_experts=16, top_k=1, sharding_profile="fsdp", remat="dots", train_accum=8))


def smoke_config() -> ArchConfig:
    return ArchConfig(name="llama4_scout_17b_a16e_smoke", family="moe",
                      n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab=256, n_experts=4, top_k=1,
                      max_cache=128)
