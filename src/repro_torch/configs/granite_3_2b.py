"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base; hf-verified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite_3_2b", family="dense", n_layers=40, d_model=2048, n_heads=32,
    n_kv_heads=8, d_ff=8192, vocab=49155, remat="dots", train_accum=4))


def smoke_config() -> ArchConfig:
    return ArchConfig(name="granite_3_2b_smoke", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      max_cache=128)
