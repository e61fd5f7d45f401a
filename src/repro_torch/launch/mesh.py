"""Meshes over the process group that already stands.

The reference builds JAX meshes over the devices XLA sees; the port is
explicit SPMD, one process per rank, so a mesh is a `DeviceMesh` over the
ranks of the default `torch.distributed` process group, with the
reference's axis names. The caller starts the group itself
(``torch.distributed.init_process_group`` with its address, world size and
rank): nothing here reads a cluster's environment.

    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=2)
    mesh = make_test_mesh(1, 2)                 # ("data", "model")

Defined as functions, never module-level constants, so importing this
module starts no process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's 16 x 16 (or 2 x 16 x 16) production mesh: 256 or 512
    ranks, which one card cannot hold. Raises; it waits with the dry run
    that lowers it (ROADMAP A9)."""
    shape = "2 x 16 x 16" if multi_pod else "16 x 16"
    raise NotImplementedError(
        f"make_production_mesh: a {shape} mesh needs as many ranks; the "
        f"port runs test meshes over the standing process group "
        f"(make_test_mesh), and the production layout waits with the dry "
        f"run (ROADMAP A9)")


def make_test_mesh(data: int = 2, model: int = 4, pod: int | None = None, *,
                   device_type: str = "cpu") -> DeviceMesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod``, over the
    ranks of the default process group in row-major order: rank r sits at
    ``divmod(r, model)`` on a two-axis mesh. The group's world size must
    equal the mesh's size. ``device_type`` is the device of the tensors the
    ranks exchange ("cuda" on the card); the transport is the group's own
    backend."""
    shape = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    if not dist.is_initialized():
        raise ValueError("make_test_mesh: start the process group first "
                         "(torch.distributed.init_process_group)")
    n = 1
    for size in shape:
        n *= size
    if dist.get_world_size() != n:
        raise ValueError(f"make_test_mesh: a {' x '.join(map(str, shape))} "
                         f"mesh needs {n} ranks, the process group has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)
