"""Nested dicts and lists of tensors: the port's pytrees.

The reference walks its parameter, gradient and optimizer trees with
``jax.tree``; the port's trees are plain dicts and lists, walked here. A
leaf is anything that is not a dict, list or tuple. Dicts are walked in
sorted key order, as ``jax.tree`` walks them, and `flatten_with_keys`
names a leaf by its path as the reference's checkpoint store does (dict
keys and list indices joined by ``/``), so a checkpoint's leaf names are
the same in both packages.
"""

from __future__ import annotations

from typing import Any, Callable

SEP = "/"


def _children(node) -> list[tuple[str, Any]] | None:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def leaves(tree: Any) -> list[Any]:
    """The leaves in walk order."""
    return list(flatten_with_keys(tree).values())


def flatten_with_keys(tree: Any) -> dict[str, Any]:
    """{path: leaf} in walk order, the path's parts joined by `SEP`."""
    out: dict[str, Any] = {}
    _walk(tree, "", out)
    return out


def _walk(node: Any, prefix: str, out: dict[str, Any]) -> None:
    # a module-level recursion: a nested one would close over itself and
    # ``out``, a cycle that keeps every leaf alive until the next gc
    children = _children(node)
    if children is None:
        out[prefix] = node
        return
    for key, child in children:
        _walk(child, f"{prefix}{SEP}{key}" if prefix else key, out)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten_like(like: Any, values: list[Any]) -> Any:
    """``values``, given in ``like``'s walk order, in ``like``'s
    structure."""
    it = iter(values)
    out = _build(like, it)
    if next(it, it) is not it:
        raise ValueError("unflatten_like: more values than leaves")
    return out


def _build(node: Any, it) -> Any:
    # module-level for the reason `_walk` is
    if isinstance(node, dict):
        built = {key: _build(node[key], it) for key in sorted(node)}
        return {key: built[key] for key in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)
