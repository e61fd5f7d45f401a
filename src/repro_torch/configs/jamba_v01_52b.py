"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
(arXiv:2403.19887). 32L = 4 x period-8 (attn at position 4, mamba elsewhere;
MoE on odd positions), d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Jamba ships Mamba-1; the reference, and so the port, runs the Mamba-2 SSD
form of the same SSM (`repro_torch.models.ssm`)."""

from repro_torch.configs.base import ArchConfig, MoeCfg, SsmCfg

_PERIOD = (
    ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
    ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
    period_layout=_PERIOD, n_periods=4,
    moe=MoeCfg(n_routed=16, top_k=2, expert_ff=14336, n_shared=0),
    ssm=SsmCfg(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
               chunk=256),
    sub_quadratic=True,
    train_microbatches=8,
)
