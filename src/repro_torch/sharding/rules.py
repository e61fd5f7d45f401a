"""Name-based sharding rules: a leaf's path in the port's trees -> its spec.

The reference's rules, on the port's trees. A spec is a tuple with one
entry a dimension: None (replicated), a mesh axis name, or a tuple of axis
names; it is the reference's ``PartitionSpec`` as a plain tuple, the mesh
implicit. Logical axes:
  fsdp  parameter/optimizer sharding axis: ("pod", "data") on a mesh with a
        pod axis, ("data",) otherwise (ZeRO-3 style).
  tp    tensor parallel axis: "model".
  dp    batch/activation axis: the same mesh axes as fsdp.

Column-parallel weights (d -> hidden) are (fsdp, tp), row-parallel ones
(hidden -> d) (tp, fsdp): their products leave partial sums over the tp
axis, the paper's partial sums at interconnect scale, which
`repro_torch.models.moe.moe_apply` combines actively (an all-reduce) or
passively (an all-gather and a local add).

The port's trees differ from the reference's in two ways, and the specs
follow the reference's logical dimensions:
  * layers are a flat list (``layers``, ``enc_layers``) where the reference
    stacks periods; a layer leaf's spec is the reference's without the
    stacked leading None.
  * self- and cross-attention caches are head-major, (B, Hkv, S, hd), where
    the reference keeps (B, S, Hkv, hd). Their specs are the reference's,
    in its order; `logical_dims` gives the port dimension of each spec
    entry, so `shard_tree` cuts the port's S dimension (2) where the spec
    names S (1).

`shard_tree` cuts a rank's local shard of a tree from its specs: the
explicit counterpart of ``jax.device_put(tree, NamedSharding)``. What this
slice holds as shards is narrower than the rules: a rank keeps its tp block
of the routed experts' ff dimension (`routed_specs`, the reference's
``shard_map`` in_specs) and, for flash decoding, its block of each KV
cache's sequence (`kv_block_specs`); everything else runs replicated, as
the reference's GSPMD placement of it is ROADMAP A9's second half.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import tree as T
from repro_torch.models.layers import CROSS_K, CROSS_V, MLA_CACHE
from repro_torch.sharding.api import Parallel, axis_sizes

Spec = tuple


def mesh_axes(mesh: DeviceMesh) -> dict[str, Any]:
    """The logical axes of a mesh and its axis sizes, as the reference's."""
    return axes_of(axis_sizes(mesh))


def axes_of(sizes: dict[str, int]) -> dict[str, Any]:
    """`mesh_axes` from axis sizes alone: {"fsdp", "tp", "dp", "sizes"}."""
    fsdp = ("pod", "data") if "pod" in sizes else ("data",)
    return {"fsdp": fsdp, "tp": "model", "dp": fsdp, "sizes": dict(sizes)}


def _axis_size(axis, sizes: dict[str, int]) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _fit(spec_axes: tuple, shape: tuple[int, ...], sizes: dict[str, int]
         ) -> Spec:
    """Drop any proposed mesh axis whose shard count does not divide the
    corresponding dim (2 kv heads on a 16-way model axis, odd vocabs on the
    fsdp axis): those dims fall back to replication. A tuple of one axis is
    that axis, as a ``PartitionSpec`` normalises it."""
    fitted = []
    for dim, axis in zip(shape, spec_axes):
        n = _axis_size(axis, sizes)
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        fitted.append(axis if (n > 1 and dim % n == 0) or n == 1 else None)
    return tuple(fitted)


_COL = {"wq", "wk", "wv", "wi", "wg", "wx", "wz", "lm_head"}
_ROW = {"wo"}
#: cache leaves whose port layout is head-major: port dims of the
#: reference's (B, S, Hkv, hd)
_HEAD_MAJOR = {"k", "v", CROSS_K, CROSS_V}


def _names(path) -> list[str]:
    return path.split(T.SEP) if isinstance(path, str) else [str(p) for p in path]


def logical_dims(path, ndim: int) -> tuple[int, ...]:
    """The port dimension of each entry of the leaf's spec: (0, 2, 1, 3)
    for a head-major attention cache, the identity otherwise."""
    if _names(path)[-1] in _HEAD_MAJOR and ndim == 4:
        return (0, 2, 1, 3)
    return tuple(range(ndim))


def _logical_shape(path, leaf) -> tuple[int, ...]:
    shape = tuple(leaf.shape)
    return tuple(shape[d] for d in logical_dims(path, len(shape)))


def param_spec(path, leaf, axes: dict) -> Spec:
    """A parameter leaf's spec. ``path``: the leaf's keys (a sequence, or
    the ``/``-joined name `repro_torch.tree.flatten_with_keys` gives)."""
    names = _names(path)
    fsdp, tp = axes["fsdp"], axes["tp"]
    ndim = len(leaf.shape)
    name_set = set(names)

    def mk(*spec):
        return _fit(spec, tuple(leaf.shape), axes["sizes"])

    if "routed" in name_set:  # (E, d, f) / (E, f, d)
        if names[-1] == "wo":
            return mk(None, tp, fsdp)
        return mk(None, fsdp, tp)
    if "router" in name_set or "shared_gate" in name_set:
        return mk(*((None,) * ndim))
    # biases / norms / scalars / small vectors
    if ndim <= 1:
        if names[-1] == "b" and len(names) >= 2 and names[-2] in _COL:
            return mk(tp)
        return mk(*((None,) * ndim))
    if names[-1] == "w" and len(names) >= 2:
        parent = names[-2]
        if parent in _COL:
            return mk(fsdp, tp)
        if parent in _ROW:
            return mk(tp, fsdp)
        if parent == "embed":
            # (vocab, d): vocab over tp, d over fsdp, so that the tied head
            # (x @ embed.T) gives vocab-sharded logits over the model axis
            return mk(tp, fsdp)
        if parent == "wkv_a":
            return mk(fsdp, None)        # (d, lora+rope): small out dim
        if parent == "wkv_b":
            return mk(None, tp)          # (lora, H*(nope+v))
        if parent in ("wbc", "wdt"):
            return mk(fsdp, None)
        if parent == "enc_proj":
            return mk(None, None)
    if names[-1] == "conv_w":            # (K, conv_dim)
        return mk(None, tp)
    return mk(*((None,) * ndim))


def cache_spec(path, leaf, axes: dict) -> Spec:
    """A cache leaf's spec, in the reference's dimension order: KV caches
    shard the sequence over tp (flash decoding: each rank reads its block,
    and the softmax over the blocks combines per-block (m, l, acc) across
    the tp axis), since head counts rarely divide it."""
    names = _names(path)
    fsdp, tp = axes["dp"], axes["tp"]
    shape = _logical_shape(path, leaf)

    def mk(*spec):
        return _fit(spec, shape, axes["sizes"])

    last = names[-1]
    if last == "pos":
        return ()
    if last in _HEAD_MAJOR:              # (B, S, Hkv, hd)
        return mk(fsdp, tp, None, None)
    if last == MLA_CACHE:                # (B, S, kv_lora + qk_rope)
        return mk(fsdp, tp, None)
    if last == "conv":                   # (B, K-1, conv_dim)
        return mk(fsdp, None, tp)
    if last == "ssm":                    # (B, h, p, n)
        return mk(fsdp, tp, None, None)
    return mk(*((None,) * len(shape)))


def tree_specs(tree: Any, fn: Callable[[str, Any], Spec]) -> Any:
    """``fn(path, leaf)`` over a tree's leaves, in the tree's structure."""
    flat = T.flatten_with_keys(tree)
    return T.unflatten_like(tree, [fn(path, leaf) for path, leaf in flat.items()])


def params_shardings(mesh: DeviceMesh, params: Any,
                     weight_mode: str = "fsdp") -> Any:
    """Each parameter's spec. weight_mode "fsdp": ZeRO-3 style weight
    sharding over the data axes; "zero2": weights replicated over fsdp
    (tp-sharded only), the optimizer state still fsdp-sharded."""
    axes = mesh_axes(mesh)
    if weight_mode == "fsdp":
        return tree_specs(params, lambda p, x: param_spec(p, x, axes))

    def zero2(path, leaf):
        return tuple(None if a == axes["fsdp"] or a == "data"
                     or (isinstance(a, tuple) and set(a) & {"data", "pod"})
                     else a for a in param_spec(path, leaf, axes))

    return tree_specs(params, zero2)


def caches_shardings(mesh: DeviceMesh, caches: Any) -> Any:
    axes = mesh_axes(mesh)
    return tree_specs(caches, lambda p, x: cache_spec(p, x, axes))


def opt_state_shardings(mesh: DeviceMesh, opt_state: Any) -> Any:
    """AdamW's m, v and master mirror the parameter specs; count is
    replicated."""
    axes = mesh_axes(mesh)

    def spec(path, leaf):
        names = _names(path)
        if names and names[0] == "count":
            return ()
        return param_spec(names[1:], leaf, axes)

    return tree_specs(opt_state, spec)


def batch_shardings(mesh: DeviceMesh, batch: Any) -> Any:
    """A batch's leaves split over dp on their leading dim where it
    divides."""
    axes = mesh_axes(mesh)

    def spec(path, leaf):
        if len(leaf.shape) == 0:
            return ()
        raw = (axes["dp"],) + (None,) * (len(leaf.shape) - 1)
        return _fit(raw, tuple(leaf.shape), axes["sizes"])

    return tree_specs(batch, spec)


def routed_specs(tree: Any, mesh: DeviceMesh, tp_axis: str = "model") -> Any:
    """The specs of what a rank holds under `moe_apply(parallel=...)`: the
    routed experts' ff dimension over tp (wg, wi (E, d, f): (None, None,
    tp); wo (E, f, d): (None, tp, None), the reference's ``shard_map``
    in_specs), every other leaf replicated."""
    sizes = axis_sizes(mesh)

    def spec(path, leaf):
        names = _names(path)
        none = (None,) * len(leaf.shape)
        if "routed" not in names or names[-1] not in ("wg", "wi", "wo"):
            return none
        raw = (None, tp_axis, None) if names[-1] == "wo" else (None, None, tp_axis)
        return _fit(raw, tuple(leaf.shape), sizes)

    return tree_specs(tree, spec)


def kv_block_specs(caches: Any, parallel: Parallel) -> Any:
    """The specs of what a rank holds for flash decoding: each
    self-attention KV cache's sequence over tp where it divides, (None, tp,
    None, None) in the reference's order; the batch, the cross caches, MLA
    and SSM state replicated."""
    sizes = axis_sizes(parallel.mesh)

    def spec(path, leaf):
        names = _names(path)
        if names[-1] in ("k", "v") and len(leaf.shape) == 4:
            return _fit((None, parallel.tp_axis, None, None),
                        _logical_shape(path, leaf), sizes)
        return (None,) * len(leaf.shape)

    return tree_specs(caches, spec)


def shard_of(leaf: torch.Tensor, spec: Spec, dims: tuple[int, ...],
             mesh: DeviceMesh) -> torch.Tensor:
    """This rank's shard of one leaf: along each port dimension ``dims[i]``
    whose spec entry names axes, the block at this rank's index over those
    axes (flattened in their order). A leaf with no sharded dimension comes
    back as it is; a cut one as a contiguous copy, so that the whole leaf
    can be freed."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    sizes = axis_sizes(mesh)
    out = leaf
    for entry, dim in zip(spec, dims):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n, i = 1, 0
        for a in axes:
            n *= sizes[a]
            i = i * sizes[a] + coord[names.index(a)]
        if n == 1:
            continue
        size = out.shape[dim] // n
        out = out.narrow(dim, i * size, size)
    return out if out is leaf else out.contiguous()


def _at(tree: Any, path: str) -> Any:
    node = tree
    for key in path.split(T.SEP):
        node = node[int(key)] if isinstance(node, (list, tuple)) else node[key]
    return node


def shard_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """This rank's local shard of every leaf of ``tree`` under ``specs`` (a
    tree of the same structure whose leaves are specs, in the reference's
    dimension order, as `tree_specs` makes them)."""
    out = []
    for path, leaf in T.flatten_with_keys(tree).items():
        out.append(shard_of(leaf, _at(specs, path),
                            logical_dims(path, leaf.dim()), mesh)
                   if isinstance(leaf, torch.Tensor) else leaf)
    return T.unflatten_like(tree, out)
