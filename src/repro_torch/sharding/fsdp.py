"""Where a train step's leaves live on a mesh: each rank holds its shard of
every parameter and AdamW leaf over the fsdp axes, gathers the whole
parameter tree before the forward, and keeps its shard of the gradient
summed over the data group after the backward. The state rests sharded,
but a step's peak holds every parameter and gradient whole besides the
shards: the gathers are of the whole tree, not a layer at a time as in
ZeRO-3.

The reference places the leaves with ``jax.device_put(tree,
rules.params_shardings(...))`` and lets GSPMD insert the gathers and the
reduce-scatters; the port calls them itself. What a rank holds is
`held_specs`: the rules' specs with the tp axis dropped, since the port
runs attention, the dense FFN, the shared expert and the LM head
replicated over tp (their tp placement is ROADMAP A9), except the routed
experts' ff dimension, which keeps its tp block
(`repro_torch.sharding.rules.routed_specs`, what `moe_apply` computes on).
A dimension the fsdp axes do not divide stays whole (the rules' ``_fit``).

Collectives (all counted in `collectives.COLLECTIVES`): ``"fsdp/params
all_gather"`` a sharded leaf a step, ``"fsdp/grads all_reduce"`` a leaf a
step (an all-reduce and a slice: gloo has no reduce-scatter; counted as
the all-reduce moves its whole leaf), ``"fsdp/norm all_reduce"`` twice a
step, a few words each.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.sharding import collectives, rules
from repro_torch.sharding.api import Parallel

_ROUTED = ("wg", "wi", "wo")


def _routed(names: list[str]) -> bool:
    return "routed" in names and names[-1] in _ROUTED


def held_spec(path, spec: rules.Spec, tp_axis: str = "model") -> rules.Spec:
    """What a rank holds of one parameter leaf whose rules spec is
    ``spec``: the fsdp entries, and the tp entry only on a routed expert's
    ff dimension."""
    if _routed(rules._names(path)):
        return spec
    return tuple(None if entry == tp_axis else entry for entry in spec)


def held_specs(mesh, params: Any, tp_axis: str = "model") -> Any:
    """`held_spec` of every leaf of ``params``, whole leaves of the global
    shapes (meta tensors will do): whether an axis divides a dimension
    decides its spec, so a rank's shards would give other specs."""
    specs = rules.params_shardings(mesh, params)
    return T.unflatten_like(params, [
        held_spec(path, rules._at(specs, path), tp_axis)
        for path in T.flatten_with_keys(params)])


def opt_held_specs(param_specs: Any) -> Any:
    """The specs of AdamW's state (`repro_torch.optim.adamw.init`) whose
    params are held as ``param_specs`` say: ``master``, ``m`` and ``v`` as
    their params, ``count`` replicated (the rules' `opt_state_shardings`,
    held)."""
    return {"count": (), "m": param_specs, "master": param_specs,
            "v": param_specs}


def _dp_dim(spec: rules.Spec, parallel: Parallel) -> int | None:
    """The dimension ``spec`` shards over the data axes, if any."""
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if entry is not None and tuple(axes) == tuple(parallel.dp_axes):
            return dim
    return None


def _gather_dim(t: torch.Tensor, dim: int, group, n: int, site: str
                ) -> torch.Tensor:
    """Every rank's ``t`` over ``group`` of ``n`` ranks, joined along
    ``dim`` in rank order."""
    g = collectives.all_gather(t.movedim(dim, 0), group, n, site=site)
    return g.reshape(n * t.shape[dim], *g.shape[2:]).movedim(0, dim).contiguous()


def _data_only(spec: rules.Spec, parallel: Parallel) -> rules.Spec:
    """``spec`` with its entry over the data axes alone."""
    dim = _dp_dim(spec, parallel)
    return tuple(entry if i == dim else None for i, entry in enumerate(spec))


def _data_specs(tree: Any, specs: Any, parallel: Parallel) -> Any:
    return T.unflatten_like(tree, [
        _data_only(rules._at(specs, path), parallel)
        for path in T.flatten_with_keys(tree)])


def gather_leaf_global(leaf: torch.Tensor, spec: rules.Spec,
                       parallel: Parallel, site: str) -> torch.Tensor:
    """One held leaf whole: gathered over the data group along the
    dimension ``spec`` shards over the data axes, and over the tp group
    along the one it shards over tp (a routed expert's ff)."""
    out = leaf
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if entry is None:
            continue
        if tuple(axes) == tuple(parallel.dp_axes) and parallel.dp_size > 1:
            out = _gather_dim(out, dim, parallel.dp_group, parallel.dp_size,
                              site)
        elif entry == parallel.tp_axis and parallel.tp_size > 1:
            out = _gather_dim(out, dim, parallel.tp_group, parallel.tp_size,
                              site)
    return out


def gather(tree: Any, specs: Any, parallel: Parallel, *,
           site: str = "fsdp/params") -> Any:
    """Every leaf of ``tree`` whole over the data axes (its tp block, where
    it has one, stays a block): `gather_leaf_global` over the data axes
    alone."""
    data = _data_specs(tree, specs, parallel)
    return T.unflatten_like(tree, [
        gather_leaf_global(leaf, rules._at(data, path), parallel, site)
        for path, leaf in T.flatten_with_keys(tree).items()])


def cut(tree: Any, specs: Any, parallel: Parallel) -> Any:
    """This rank's block over the data axes of every leaf of ``tree`` that
    ``specs`` shard there, as a contiguous copy; the others as they are
    (`rules.shard_tree` over the data axes alone)."""
    return rules.shard_tree(tree, _data_specs(tree, specs, parallel),
                            parallel.mesh)


def reduce_grads(grads: Any, specs: Any, parallel: Parallel) -> Any:
    """Each gradient leaf summed over the data group, then this rank's
    block of it over the data axes (`cut`)."""
    if parallel.dp_size > 1:
        for g in T.leaves(grads):
            collectives.all_reduce(g, parallel.dp_group, site="fsdp/grads")
    return cut(grads, specs, parallel)


def global_norm(grads: Any, specs: Any, parallel: Parallel) -> torch.Tensor:
    """The global norm of gradients held as ``specs`` say, each leaf
    counted once: the squares of the leaves split over tp are summed over
    the tp group, those of the leaves split over the data axes over the
    data group (a leaf split over both: over both), and a leaf no axis
    splits is counted as it is. fp32, 0-d, equal on every rank."""
    sums = {}
    for path, g in T.flatten_with_keys(grads).items():
        spec = rules._at(specs, path)
        key = (_dp_dim(spec, parallel) is not None,
               parallel.tp_axis in spec and parallel.tp_size > 1)
        sq = torch.sum(torch.square(g.float()))
        sums[key] = sums[key] + sq if key in sums else sq
    zero = torch.zeros((), dtype=torch.float32,
                       device=T.leaves(grads)[0].device)
    both, dp_only, tp_only, rep = (sums.get(k, zero) for k in (
        (True, True), (True, False), (False, True), (False, False)))
    over_tp = collectives.all_reduce(torch.stack([both, tp_only]),
                                     parallel.tp_group, site="fsdp/norm")
    over_dp = collectives.all_reduce(torch.stack([over_tp[0], dp_only]),
                                     parallel.dp_group, site="fsdp/norm")
    return torch.sqrt(over_dp.sum() + over_tp[1] + rep)
