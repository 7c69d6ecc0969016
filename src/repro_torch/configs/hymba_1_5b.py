"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention+mamba heads per layer, 128
learned meta tokens, SWA on the attention path => runs long_500k.
25 heads do not divide the 16-way model axis: attention runs
head-replicated (sharding resolver fallback; model is 1.5B so this fits) with
TP on the SSM inner dim and MLP — recorded in DESIGN.md §6.
[arXiv:2411.13676; hf-verified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba_1_5b", family="hybrid", n_layers=32, d_model=1600, n_heads=25,
    n_kv_heads=5, d_ff=5504, vocab=32001, head_dim=64, ssm_state=16,
    swa_window=1024, meta_tokens=128, remat="dots", train_accum=4))


def smoke_config() -> ArchConfig:
    return ArchConfig(name="hymba_1_5b_smoke", family="hybrid", n_layers=2,
                      d_model=64, n_heads=5, n_kv_heads=1, d_ff=128, vocab=256,
                      head_dim=16, ssm_state=8, ssm_head_dim=16,
                      swa_window=32, meta_tokens=8, max_cache=128)
