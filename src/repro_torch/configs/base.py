"""Architecture configuration system (a copy of the reference's data
classes; ``param_count`` counts with this package's `count_params`).

An ``ArchConfig`` fully describes one model: the layer stack is a repeated
*period* of sublayers (``period_layout``), which uniformly expresses dense
transformers (period of 1), jamba's 1:7 mamba:attn interleave with alternating
MoE (period of 8), and llama-3.2-vision's every-5th cross-attention layer
(period of 5). The port runs the stack as a Python loop over its layers.

Input shapes (the assignment's 4 shapes) are in ``SHAPES``; smoke-reduced
configs preserve every structural feature at toy width.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "attn+cross", "cross", "mamba"]
Ffn = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    n_routed: int
    top_k: int
    expert_ff: int
    n_shared: int = 0
    shared_ff: int = 0
    shared_gate: bool = False       # qwen2-moe gates the shared expert
    norm_topk: bool = True
    router_aux_weight: float = 0.01
    impl: str = "capacity"          # "capacity" (GShard buffers, any backend)
                                    # | "ragged" (ragged_dot grouped GEMM, TPU)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MlaCfg:
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class SsmCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class EncoderCfg:
    """Encoder stack for enc-dec models (seamless): self-attn, non-causal."""
    n_layers: int
    frontend_dim: int    # stubbed modality frontend output dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    period_layout: tuple[tuple[Mixer, Ffn], ...]
    n_periods: int
    head_dim: int | None = None            # default d_model // n_heads
    act: str = "silu"                      # mlp activation
    norm: str = "rmsnorm"                  # "rmsnorm" | "layernorm"
    gated_mlp: bool = True                 # SwiGLU/GeGLU vs plain
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embed: bool = False
    embed_scale: bool = False              # gemma: embeddings * sqrt(d)
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    moe: MoeCfg | None = None
    mla: MlaCfg | None = None
    ssm: SsmCfg | None = None
    encoder: EncoderCfg | None = None
    first_dense_layers: int = 0            # deepseek: leading dense layers
    first_dense_ff: int = 0
    n_vision_tokens: int = 0               # vlm: stubbed patch-embedding count
    sliding_window: int | None = None
    sub_quadratic: bool = False            # supports long_500k decode
    dtype: str = "bfloat16"
    unroll_scan: bool = False              # python-loop periods (cost compiles:
                                           # XLA counts while bodies once)
    attn_chunk: int = 1024                 # online-softmax KV chunk
    train_microbatches: int = 1            # gradient-accumulation slices

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 256 (= 16 tp x 16 fsdp) so the
        embedding/lm-head shard on both axes regardless of the checkpoint's
        vocab (50280, 256206, ...). Standard practice (MaxText pads too);
        padded ids simply participate in the softmax."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def n_layers(self) -> int:
        return (self.first_dense_layers
                + self.n_periods * len(self.period_layout))

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in the roofline)."""
        from repro_torch.models.transformer import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.transformer import count_params
        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """long_500k needs sub-quadratic sequence mixing (SSM/hybrid); skipped for
    pure full-attention archs per the assignment (recorded in DESIGN.md)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names
