"""qwen2-moe-a2.7b [moe] — 60 routed top-4 + gated shared expert
(hf:Qwen/Qwen1.5-MoE-A2.7B). 24L d_model=2048 16H (kv=16) expert_ff=1408
shared_ff=5632 vocab=151936."""

from repro_torch.configs.base import ArchConfig, MoeCfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    d_model=2048, n_heads=16, n_kv_heads=16, d_ff=5632, vocab=151936,
    period_layout=(("attn", "moe"),), n_periods=24,
    qkv_bias=True,
    moe=MoeCfg(n_routed=60, top_k=4, expert_ff=1408, n_shared=1,
               shared_ff=5632, shared_gate=True, norm_topk=True),
    train_microbatches=8,
)
