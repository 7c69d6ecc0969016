"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
qk_norm + GQA; head_dim=128 explicit per the Qwen3 recipe.
[hf:Qwen/Qwen3-8B family; hf-verified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3_4b", family="dense", n_layers=36, d_model=2560, n_heads=32,
    n_kv_heads=8, d_ff=9728, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1_000_000.0, remat="dots", train_accum=4))


def smoke_config() -> ArchConfig:
    return ArchConfig(name="qwen3_4b_smoke", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      head_dim=32, qk_norm=True, max_cache=128)
