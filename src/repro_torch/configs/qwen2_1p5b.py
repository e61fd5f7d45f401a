"""qwen2-1.5b [dense] — GQA + QKV bias (arXiv:2407.10671).
28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense",
    d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936,
    period_layout=(("attn", "dense"),), n_periods=28,
    qkv_bias=True, tie_embed=True, rope_theta=1e6,
    train_microbatches=4,
)
