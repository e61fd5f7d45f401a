"""The parallelism context threaded through model code.

The reference's `Parallel` names a JAX mesh and lets GSPMD and
``shard_map`` place the tensors. The port is explicit SPMD: one process per
rank, each holding its own shard and calling the collectives itself, so
`Parallel` carries a `DeviceMesh` and answers what a rank needs: its index
and group on the tensor-parallel axis and on the data axes.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Literal

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

STRATEGIES = ("active", "passive")
REMATS = ("none", "dots", "full")


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class Parallel:
    """Everything model code needs to know about the mesh.

    psum_strategy: how tensor-parallel partial sums are combined:
      "active"  an all-reduce: the reduction happens in the interconnect,
                the paper's active memory controller at interconnect scale;
      "passive" an all-gather of every rank's partial and a local add: the
                paper's read-back baseline.
    remat: the activation checkpoint policy of a forward with a gradient
      (`repro_torch.models.transformer.forward`), over each layer, the
      port's period: "full" recomputes the layer in the backward, "dots"
      keeps its matmul outputs and recomputes the rest, "none" keeps
      everything. The values do not change.
    flash_decode: a one-token decode step attends over the rank's block of
      the sequence-sharded KV cache and combines the blocks' partial
      softmax sums across the tp axis (`repro_torch.sharding.flash_decode`).
    seq_shard_attn: the reference's sequence-parallel annotation of
      attention; a sharding annotation that leaves the math unchanged, so a
      no-op in the port.
    batch_split: the batch is already this rank's slice over the data axes,
      as a train step cuts it (`split_batch`): the MoE neither cuts its
      tokens over the data axes nor gathers them back, and its
      load-balancing loss takes its per-expert means over the data group,
      as the reference's GSPMD takes them over the global batch.

    Constructing one on every rank, in the same order, is a collective:
    data axes other than one mesh axis get a process group of their own.
    """
    mesh: DeviceMesh
    dp_axes: tuple[str, ...]
    tp_axis: str = "model"
    psum_strategy: Literal["active", "passive"] = "active"
    remat: Literal["none", "dots", "full"] = "full"
    flash_decode: bool = False
    seq_shard_attn: bool = True
    batch_split: bool = False

    def __post_init__(self) -> None:
        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"Parallel: mesh must be a torch DeviceMesh "
                            f"(repro_torch.launch.mesh.make_test_mesh), got "
                            f"{type(self.mesh).__name__}")
        names = self.mesh.mesh_dim_names or ()
        missing = [a for a in (self.tp_axis, *self.dp_axes) if a not in names]
        if missing:
            raise ValueError(f"Parallel: axes {missing} are not on the mesh's "
                             f"{names}")
        if self.psum_strategy not in STRATEGIES:
            raise ValueError(f"Parallel: psum_strategy {self.psum_strategy!r} "
                             f"is not one of {STRATEGIES}")
        if self.remat not in REMATS:
            raise ValueError(f"Parallel: remat {self.remat!r} is not one of "
                             f"{REMATS}")
        object.__setattr__(self, "_dp_group", self._make_dp_group())

    def split_batch(self) -> "Parallel":
        """This context with ``batch_split`` set, sharing its process
        groups (no collective)."""
        out = copy.copy(self)
        object.__setattr__(out, "batch_split", True)
        return out

    def _make_dp_group(self):
        """The process group of the ranks that share this rank's tp index:
        one mesh axis's group, or a new group over several data axes (every
        rank creates every such group, as `torch.distributed.new_group`
        requires)."""
        if len(self.dp_axes) == 1:
            return self.mesh.get_group(self.dp_axes[0])
        if not self.dp_axes:
            return None
        names = list(self.mesh.mesh_dim_names)
        dims = [names.index(a) for a in self.dp_axes]
        rest = [i for i in range(len(names)) if i not in dims]
        grid = self.mesh.mesh.permute(*rest, *dims).reshape(
            -1, self.dp_size)
        mine = None
        for ranks in grid.tolist():
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = group
        return mine

    @property
    def tp_size(self) -> int:
        return axis_sizes(self.mesh)[self.tp_axis]

    @property
    def tp_rank(self) -> int:
        return self.mesh.get_local_rank(self.tp_axis)

    @property
    def tp_group(self):
        return self.mesh.get_group(self.tp_axis)

    @property
    def dp_size(self) -> int:
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in self.dp_axes:
            n *= sizes[a]
        return n

    @property
    def dp_rank(self) -> int:
        """This rank's index over the data axes, flattened in their order."""
        sizes = axis_sizes(self.mesh)
        i = 0
        for a in self.dp_axes:
            i = i * sizes[a] + self.mesh.get_local_rank(a)
        return i

    @property
    def dp_group(self):
        return self._dp_group


def make_parallel(mesh: DeviceMesh, *, psum_strategy: str = "active",
                  remat: str = "full", flash_decode: bool = False,
                  seq_shard_attn: bool = True) -> Parallel:
    """The reference's defaults: the data axes are ("pod", "data") on a
    mesh with a pod axis, else ("data",); tp is "model"."""
    multi = "pod" in (getattr(mesh, "mesh_dim_names", None) or ())
    dp = ("pod", "data") if multi else ("data",)
    return Parallel(mesh=mesh, dp_axes=dp, psum_strategy=psum_strategy,
                    remat=remat, flash_decode=flash_decode,
                    seq_shard_attn=seq_shard_attn)


def check_parallel(parallel, where: str) -> Parallel:
    """``parallel`` itself, or a TypeError naming what a `Parallel` needs."""
    if not isinstance(parallel, Parallel):
        raise TypeError(
            f"{where}: parallel must be a repro_torch.sharding.api.Parallel "
            f"(a DeviceMesh with the tp axis and the data axes, and the "
            f"psum_strategy), got {type(parallel).__name__}")
    return parallel
