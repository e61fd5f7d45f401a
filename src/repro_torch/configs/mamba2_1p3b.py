"""mamba2-1.3b [ssm] — SSD state-space duality (arXiv:2405.21060).
48L d_model=2048, attention-free, d_ff=0, vocab=50280, ssm_state=128."""

from repro_torch.configs.base import ArchConfig, SsmCfg

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    d_model=2048, n_heads=8, n_kv_heads=8,   # unused: no attention layers
    d_ff=0, vocab=50280,
    period_layout=(("mamba", "none"),), n_periods=48,
    ssm=SsmCfg(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
               chunk=256),
    tie_embed=True, sub_quadratic=True,
    train_microbatches=4,
)
