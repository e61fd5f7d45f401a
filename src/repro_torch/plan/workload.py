"""Workload descriptions: what the planner schedules.

`ConvWorkload` is one convolution layer as the paper's model sees it, planned
against a MAC budget P (eq 1). `MatmulWorkload` is one GEMM C[M,N] =
A[M,K] @ B[K,N], planned against a per-block on-chip byte budget; its element
types are torch dtypes. Both are frozen, so they can key caches and compare
field by field. `transformer_matmuls` turns an ``ArchConfig`` into its GEMMs.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch


@dataclasses.dataclass(frozen=True)
class ConvWorkload:
    """One convolution layer: the paper's (M, N, K, Wi/Hi, Wo/Ho) symbols."""

    name: str
    cin: int          # M: input feature maps
    cout: int         # N: output feature maps
    k: int            # kernel size (square)
    wi: int           # input spatial width
    hi: int           # input spatial height
    wo: int           # output spatial width
    ho: int           # output spatial height
    stride: int = 1
    groups: int = 1
    word_bytes: int = 4   # fp32 words on the SoC interconnect

    @property
    def in_acts(self) -> int:
        return self.wi * self.hi * self.cin

    @property
    def out_acts(self) -> int:
        return self.wo * self.ho * self.cout

    @property
    def macs(self) -> int:
        return (self.wo * self.ho * self.cout * self.cin // self.groups) * self.k * self.k

    @classmethod
    def from_layer(cls, layer) -> "ConvWorkload":
        """Adapter from `repro_torch.core.cnn_zoo.ConvLayer` (duck-typed)."""
        return cls(name=layer.name, cin=layer.cin, cout=layer.cout, k=layer.k,
                   wi=layer.wi, hi=layer.hi, wo=layer.wo, ho=layer.ho,
                   stride=layer.stride, groups=layer.groups)


@dataclasses.dataclass(frozen=True)
class MatmulWorkload:
    """One GEMM C[M,N] = A[M,K] @ B[K,N] with its element types."""

    m: int
    n: int
    k: int
    name: str = "matmul"
    in_dtype: torch.dtype = torch.bfloat16    # operands
    acc_dtype: torch.dtype = torch.float32    # partial sums

    @property
    def flops(self) -> int:
        return 2 * self.m * self.n * self.k


Workload = Union[ConvWorkload, MatmulWorkload]


def conv_workloads(name_or_layers) -> tuple[ConvWorkload, ...]:
    """All conv workloads of a named CNN (`repro_torch.core.cnn_zoo`) or of a
    layer list."""
    if isinstance(name_or_layers, str):
        from repro_torch.core.cnn_zoo import get_cnn
        layers = get_cnn(name_or_layers)
    else:
        layers = name_or_layers
    return tuple(ConvWorkload.from_layer(l) for l in layers)


def transformer_matmuls(cfg, *, seq_len: int = 4096, batch: int = 1,
                        include_lm_head: bool = True) -> tuple[MatmulWorkload, ...]:
    """The per-layer GEMMs of a transformer ``ArchConfig`` as workloads.

    Token-major shapes (tokens = batch * seq_len on the M axis), one workload
    per distinct projection: qkv (fused), attention out, the FFN matmuls
    (gated: up+gate fused), and optionally the LM head. MoE configs use the
    routed expert width (per-expert GEMM at top_k-scaled token count).
    """
    t = batch * seq_len
    d = cfg.d_model
    hd = cfg.hd
    q_out = cfg.n_heads * hd
    kv_out = 2 * cfg.n_kv_heads * hd
    loads = [
        MatmulWorkload(name=f"{cfg.name}/qkv", m=t, n=q_out + kv_out, k=d),
        MatmulWorkload(name=f"{cfg.name}/attn_out", m=t, n=d, k=q_out),
    ]
    if cfg.moe is not None:
        ff = cfg.moe.expert_ff
        te = max(1, t * cfg.moe.top_k // max(1, cfg.moe.n_routed))
        up_n = 2 * ff if cfg.gated_mlp else ff
        loads += [
            MatmulWorkload(name=f"{cfg.name}/expert_up", m=te, n=up_n, k=d),
            MatmulWorkload(name=f"{cfg.name}/expert_down", m=te, n=d, k=ff),
        ]
    elif cfg.d_ff:
        up_n = 2 * cfg.d_ff if cfg.gated_mlp else cfg.d_ff
        loads += [
            MatmulWorkload(name=f"{cfg.name}/ffn_up", m=t, n=up_n, k=d),
            MatmulWorkload(name=f"{cfg.name}/ffn_down", m=t, n=d, k=cfg.d_ff),
        ]
    if include_lm_head:
        loads.append(MatmulWorkload(name=f"{cfg.name}/lm_head", m=t,
                                    n=cfg.padded_vocab, k=d))
    return tuple(loads)
