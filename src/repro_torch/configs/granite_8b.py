"""granite-8b [dense] — llama-arch code model (arXiv:2405.04324).
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336, vocab=49152,
    period_layout=(("attn", "dense"),), n_periods=36,
    rope_theta=1e7,
    train_microbatches=8,
)
