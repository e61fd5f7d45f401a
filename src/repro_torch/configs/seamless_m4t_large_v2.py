"""seamless-m4t-large-v2 [audio] — enc-dec multimodal (arXiv:2308.11596).
24L enc + 24L dec, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
The speech/text frontend is a stub: the batch carries precomputed frame
embeddings as ``frames`` (B, S_enc, frontend_dim),
`repro_torch.data.make_extra_inputs`."""

from repro_torch.configs.base import ArchConfig, EncoderCfg

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206,
    period_layout=(("attn+cross", "dense"),), n_periods=24,
    encoder=EncoderCfg(n_layers=24, frontend_dim=1024),
    gated_mlp=False, act="relu", norm="layernorm",
    train_microbatches=4,
)
