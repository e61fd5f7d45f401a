"""GPipe-style pipeline parallelism over the "pod" axis (the reference's
``repro/runtime/pipeline.py``, a prototype there too).

The multi-pod mesh's pod axis composes with data parallelism by default;
this module is the alternative, pod = pipeline stages: the layer stack
splits into per-stage runs and microbatches stream through the stages,
each activation hopping to the next stage once a tick. The reference's
``shard_map`` over the pod axis becomes one process a stage, and its
``ppermute`` one `torch.distributed.batch_isend_irecv` a tick between the
stage and its neighbours, their ranks taken from the mesh's pod group
(`repro_torch.sharding.collectives.exchange`, counted under ``"pipeline
send_recv"``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.sharding import collectives

SITE = "pipeline"


def _stage_params(stacked: Any, stage: int, n_stages: int) -> Any:
    """This stage's params: each leaf's entry ``stage`` of its leading
    stage axis, or entry 0 of a leaf that holds this stage alone (leading
    dim 1, as the reference's ``shard_map`` body sees it)."""
    def pick(t):
        if t.shape[0] == n_stages:
            return t[stage]
        if t.shape[0] == 1:
            return t[0]
        raise ValueError(f"pipeline_apply: a stage-stacked leaf leads with "
                         f"{t.shape[0]}, neither {n_stages} stages nor 1")
    return T.tree_map(pick, stacked)


def pipeline_apply(mesh, n_stages: int, stage_fn: Callable,
                   stage_params_stacked: Any,
                   x_microbatches: torch.Tensor) -> torch.Tensor:
    """Run ``stage_fn(params_i, x) -> x`` as an ``n_stages`` pipeline over
    ``mesh``'s "pod" axis, this process its stage at its pod index.

    stage_params_stacked: a tree whose leaves lead with the stage axis
      (``n_stages``, this rank taking its entry), or with 1 where the rank
      holds its own stage only.
    x_microbatches: (M, mb, ...) microbatches, the same on every rank; M >=
      n_stages for full use.

    Returns the (M, mb, ...) outputs on every rank. Schedule: GPipe's fill
    and flush over M + n_stages - 1 ticks; at each tick every stage runs
    one microbatch (stage 0 takes microbatch t, clipped to M - 1), the last
    stage keeps what it finished, and each result hops to the next stage
    (the last stage's to the first, which ignores it). Only the last stage
    fills its outputs, so an all-reduce over the pod group (the active
    combine) gives every rank the result."""
    group = mesh.get_group("pod")
    stage = mesh.get_local_rank("pod")
    if mesh.size(mesh.mesh_dim_names.index("pod")) != n_stages:
        raise ValueError(f"pipeline_apply: {n_stages} stages over a pod axis "
                         f"of {mesh.size(mesh.mesh_dim_names.index('pod'))}")
    params = _stage_params(stage_params_stacked, stage, n_stages)
    send_to = dist.get_global_rank(group, (stage + 1) % n_stages)
    recv_from = dist.get_global_rank(group, (stage - 1) % n_stages)
    m = x_microbatches.shape[0]
    buf = torch.zeros_like(x_microbatches[0])
    outs = torch.zeros_like(x_microbatches)
    for t in range(m + n_stages - 1):
        incoming = (x_microbatches[min(t, m - 1)].to(buf.dtype) if stage == 0
                    else buf)
        y = stage_fn(params, incoming)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
        buf = (y if n_stages == 1 else
               collectives.exchange(y, group, send_to, recv_from, site=SITE))
    return collectives.all_reduce(outs, group, site=SITE)
