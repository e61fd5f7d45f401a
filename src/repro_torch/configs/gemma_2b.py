"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (arXiv:2403.08295).
18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000,
    period_layout=(("attn", "dense"),), n_periods=18,
    act="gelu", tie_embed=True, embed_scale=True,
    train_microbatches=4,
)
