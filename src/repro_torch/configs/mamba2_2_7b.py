"""mamba2-2.7b [ssm] — 64L d_model=2560, attention-free, vocab=50280,
ssm_state=128; SSD (state-space duality) chunked dual form: intra-chunk
matmuls (MXU) + O(1) inter-chunk state carry => runs long_500k.
[arXiv:2405.21060; unverified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2_2_7b", family="ssm", n_layers=64, d_model=2560, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, ssm_state=128, remat="dots", train_accum=8))


def smoke_config() -> ArchConfig:
    return ArchConfig(name="mamba2_2_7b_smoke", family="ssm", n_layers=2,
                      d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=256,
                      ssm_state=16, ssm_head_dim=16, max_cache=128)
