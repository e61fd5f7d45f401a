"""Gradient compression for a cheaper data-parallel reduction (the
reference's ``repro/optim/compress.py``), on tensors.

Two levels, as the reference's docstring sets out: bf16 gradients come
with mixed precision, and this module adds int8 with error feedback: a
per-leaf scale, each leaf quantized to int8, the ints summed over the data
axes, dequantized with the largest scale of the group, divided by the data
axes' size, and the quantization residual carried into the next step (the
1-bit SGD / DGC lineage). The arithmetic is the reference's as written: the
sum is of ``q`` cast to int32, so each word crosses the interconnect as 4
bytes, as many as an fp32 gradient's.

The reference runs the body under ``shard_map`` over the data axes; the
port is one process a rank, so each rank calls `compressed_allreduce` on
its own gradients and the collectives run over its data group
(`repro_torch.sharding.collectives`, counted under ``"compress"``: one
MAX of every leaf's scale at once, then one int32 SUM a leaf).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.sharding import collectives
from repro_torch.sharding.api import Parallel, axis_sizes

SITE = "compress"


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale 0-d fp32): scale = max |x| / 127 (at least 1e-12 /
    127), q = x / scale rounded half to even and clipped to +-127."""
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(grads: Any) -> Any:
    """A zero fp32 residual shaped like each gradient leaf."""
    return T.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)


def _data_group(parallel_or_mesh, dp_axes: tuple[str, ...]):
    """The process group over ``dp_axes`` and its size: a `Parallel`'s data
    group (its ``dp_axes`` must be these), or one axis of a DeviceMesh."""
    if isinstance(parallel_or_mesh, Parallel):
        if tuple(dp_axes) != tuple(parallel_or_mesh.dp_axes):
            raise ValueError(f"compressed_allreduce: dp_axes {dp_axes} are not "
                             f"the Parallel's {parallel_or_mesh.dp_axes}")
        return parallel_or_mesh.dp_group, parallel_or_mesh.dp_size
    if len(dp_axes) != 1:
        raise ValueError(f"compressed_allreduce: data axes {dp_axes} over a "
                         f"DeviceMesh need a group of their own; pass the "
                         f"Parallel, which holds it")
    return (parallel_or_mesh.get_group(dp_axes[0]),
            axis_sizes(parallel_or_mesh)[dp_axes[0]])


def compressed_allreduce(grads: Any, error: Any, parallel_or_mesh,
                         dp_axes: tuple[str, ...]) -> tuple[Any, Any]:
    """All-reduce ``grads`` over ``dp_axes`` in int8 with error feedback.

    ``grads`` are this rank's own gradient contribution, ``error`` its
    residual (`init_error_feedback`); ``parallel_or_mesh`` a `Parallel` or
    a DeviceMesh. Returns (the mean gradient, the same on every rank of
    the group; the new residual), fp32 trees like ``grads``."""
    group, n = _data_group(parallel_or_mesh, dp_axes)
    flat_g, flat_e = T.leaves(grads), T.leaves(error)
    qs, scales, new_err = [], [], []
    for g, e in zip(flat_g, flat_e):
        gl = g.to(torch.float32) + e
        q, scale = quantize_int8(gl)
        new_err.append(gl - dequantize_int8(q, scale))
        qs.append(q)
        scales.append(scale)
    top = collectives.all_reduce(torch.stack(scales), group,
                                 op=dist.ReduceOp.MAX, site=SITE)
    mean = [dequantize_int8(collectives.all_reduce(q.to(torch.int32), group,
                                                   site=SITE), s) / n
            for q, s in zip(qs, top)]
    return T.unflatten_like(grads, mean), T.unflatten_like(error, new_err)
