"""llama-3.2-vision-90b [vlm] — cross-attn image layers
(hf:meta-llama/Llama-3.2-90B-Vision). 100L = 20 x (4 self + 1 cross),
d_model=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256. The vision frontend
is a stub: the batch carries precomputed patch embeddings as ``vision_ctx``
(B, n_vision_tokens, d_model), `repro_torch.data.make_extra_inputs`."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
    period_layout=(("attn", "dense"),) * 4 + (("cross", "dense"),),
    n_periods=20,
    rope_theta=5e5,
    n_vision_tokens=1664,   # 1601 CLIP-style patch tokens padded to 13*128
    train_microbatches=16,
)
