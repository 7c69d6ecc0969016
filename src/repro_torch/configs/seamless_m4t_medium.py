"""seamless-m4t-medium [audio] — enc-dec, 12L+12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206.  The audio frontend is a STUB per assignment:
input_specs() feeds precomputed frame embeddings (B, enc_frames, d_model);
decode shapes exercise the text decoder with cross-attention.
[arXiv:2308.11596; hf-verified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless_m4t_medium", family="encdec", n_layers=12, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206, enc_layers=12,
    enc_frames=1024, remat="dots", train_accum=2))


def smoke_config() -> ArchConfig:
    return ArchConfig(name="seamless_m4t_medium_smoke", family="encdec",
                      n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab=256, enc_layers=2, enc_frames=16,
                      max_cache=128)
