"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5 family; hf-verified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen15_32b", family="dense", n_layers=64, d_model=5120, n_heads=40,
    n_kv_heads=40, d_ff=27392, vocab=152064, head_dim=128, qkv_bias=True,
    remat="dots", train_accum=8))


def smoke_config() -> ArchConfig:
    return ArchConfig(name="qwen15_32b_smoke", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=256,
                      qkv_bias=True, max_cache=128)
