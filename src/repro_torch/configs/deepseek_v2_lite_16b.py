"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6
(arXiv:2405.04434; the -Lite checkpoint has 64 routed experts, DeepSeek-V2
itself 160). 27L = 1 dense (d_ff=10944) + 26 MoE, d_model=2048, 16H,
vocab=102400."""

from repro_torch.configs.base import ArchConfig, MlaCfg, MoeCfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944, vocab=102400,
    period_layout=(("attn", "moe"),), n_periods=26,
    first_dense_layers=1, first_dense_ff=10944,
    mla=MlaCfg(kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
    moe=MoeCfg(n_routed=64, top_k=6, expert_ff=1408, n_shared=2,
               shared_ff=2816, shared_gate=False, norm_topk=False),
    train_microbatches=8,
)
