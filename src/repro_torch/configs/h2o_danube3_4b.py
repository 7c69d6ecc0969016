"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000; llama+mistral mix with sliding-window attention (window 4096)
=> sub-quadratic, runs long_500k. [arXiv:2401.16818; unverified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o_danube3_4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, d_ff=10240, vocab=32000, swa_window=4096,
    remat="dots", train_accum=4))


def smoke_config() -> ArchConfig:
    return ArchConfig(name="h2o_danube3_4b_smoke", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      swa_window=32, max_cache=128)
