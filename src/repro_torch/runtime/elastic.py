"""Elastic re-meshing (the reference's ``repro/runtime/elastic.py``):
rebuild the mesh after losing ranks and continue from the latest
checkpoint with re-sharded state.

On a real fleet the runtime would detect the failed slice (missed
heartbeats), drain, pick the largest healthy rectangle and restart the job
on it. What the framework must guarantee, and what this module and its
tests show, is that training state round-trips across mesh shapes: the
checkpoint holds global leaves (`repro_torch.checkpoint.store`, the shards
gathered and rank 0 writing), so `resume_on_mesh` can cut any new mesh's
shards from them. In the port a mesh is a `DeviceMesh` over the ranks of
the process group that stands: the restarted job starts its group first,
with as many ranks as survive.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.errors import BudgetError
from repro_torch.sharding import fsdp, rules

if TYPE_CHECKING:
    from repro_torch.faults.models import EngineDegrade


def healthy_shape(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """The (data, model) shape of the biggest healthy mesh: keep the
    model-parallel degree (weight layouts stay valid), drop data-parallel
    replicas; survivors that do not divide idle the remainder. Pure
    arithmetic, shared by `largest_healthy_mesh` and the CPU tests.

    Raises `repro_torch.errors.BudgetError` when fewer devices survive than
    the model-parallel degree needs: the degradation that cannot be served,
    the mesh's counterpart of a plan's infeasible MAC budget."""
    if n_devices < model_parallel:
        raise BudgetError(f"need >= {model_parallel} devices for TP; have "
                          f"{n_devices}")
    return n_devices // model_parallel, model_parallel


def surviving_devices(degrade: "EngineDegrade", n_devices: int) -> int:
    """How many devices an `EngineDegrade` fault leaves: its explicit
    ``surviving_devices`` pin when given, else the floor of the surviving
    fraction (at least one)."""
    if degrade.surviving_devices is not None:
        return min(int(degrade.surviving_devices), n_devices)
    return max(1, int(n_devices * degrade.surviving_frac))


def largest_healthy_mesh(n_devices: "int | EngineDegrade",
                         model_parallel: int, *, device_type: str = "cpu"):
    """Given a surviving rank count, or the `EngineDegrade` event that
    caused it (resolved against the ranks of the process group that
    stands), the biggest (data, model) mesh that keeps the model-parallel
    degree, over the group's first data x model ranks in row-major order.
    ``device_type`` as in `repro_torch.launch.mesh.make_test_mesh`."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise ValueError("largest_healthy_mesh: start the process group "
                         "first (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if not isinstance(n_devices, int):
        n_devices = surviving_devices(n_devices, world)
    data, model = healthy_shape(min(n_devices, world), model_parallel)
    return DeviceMesh(device_type,
                      torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def resume_on_mesh(ckpt: CheckpointManager, mesh, params_like, opt_like,
                   device=None):
    """Restore the newest checkpoint re-sharded for ``mesh``: each global
    leaf cut to this rank's shard (`fsdp.held_specs`, ``opt_held_specs``)
    on the host, then moved to ``device`` (the CPU by default).
    ``params_like`` and ``opt_like`` give the global shapes and dtypes
    (tensors, meta tensors included). Returns (step, params, opt_state)."""
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError("no checkpoint to resume from")
    p_specs = fsdp.held_specs(mesh, params_like)
    specs = {"params": p_specs, "opt_state": fsdp.opt_held_specs(p_specs)}
    meta = T.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"),
                      {"params": params_like, "opt_state": opt_like})
    local = {key: rules.shard_tree(meta[key], specs[key], mesh)
             for key in meta}
    restored = ckpt.restore(step, local, device=device or "cpu",
                            shardings=specs, mesh=mesh)
    return step, restored["params"], restored["opt_state"]
