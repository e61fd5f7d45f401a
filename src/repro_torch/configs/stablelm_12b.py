"""stablelm-12b [dense] (hf:stabilityai/stablelm-2-12b).
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352, per-head QK-norm."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824, vocab=100352,
    period_layout=(("attn", "dense"),), n_periods=40,
    qk_norm=True,
    train_microbatches=8,
)
