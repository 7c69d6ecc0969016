"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early-fusion VLM: VQ image tokens are ordinary vocab entries, so
the backbone is a dense decoder and the modality frontend stub provides token
ids only.  qk_norm per the Chameleon-34B recipe. [arXiv:2405.09818;
unverified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon_34b", family="vlm", n_layers=48, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22016, vocab=65536, qk_norm=True, remat="dots", train_accum=8))


def smoke_config() -> ArchConfig:
    return ArchConfig(name="chameleon_34b_smoke", family="vlm", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      qk_norm=True, max_cache=128)
