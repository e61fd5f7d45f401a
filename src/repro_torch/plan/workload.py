"""Workload descriptions: what the planner schedules.

`ConvWorkload` is one convolution layer as the paper's model sees it, planned
against a MAC budget P (eq 1). `MatmulWorkload` is one GEMM C[M,N] =
A[M,K] @ B[K,N], planned against a per-block on-chip byte budget; its element
types are torch dtypes. Both are frozen, so they can key caches and compare
field by field.
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
