"""Walks over nested containers of tensors: the part of ``jax.tree`` that the
port needs (optimizer state, gradients, checkpoints, sharding rules).

A tree is a dict, list, tuple or NamedTuple of trees, ``None`` (no leaves),
or a leaf.  Leaves come in one fixed order, the one ``jax.tree.leaves``
gives: a dict's values by sorted key, a list's or tuple's in index order.
Checkpoints number their files in this order (``arr_<i>.npy``).
"""
from __future__ import annotations

from typing import Any, Callable


def _children(tree) -> list | None:
    """``tree``'s children in leaf order, or None for a leaf."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def tree_leaves(tree: Any) -> list:
    """Every leaf of ``tree``, in the module's fixed order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_paths(tree: Any, prefix: str = "") -> list[str]:
    """The path of each leaf (``"blocks/0/attn/wq"``), in leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", range(len(tree)))
        return [p for name, kid in zip(fields, tree) for p in tree_paths(kid, f"{prefix}{name}/")]
    return [prefix.rstrip("/")]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on each leaf of ``tree`` (and the matching leaves of ``rest``,
    trees of the same structure), in a tree of ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        kids = [tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True)]
        if hasattr(tree, "_fields"):            # a NamedTuple
            return type(tree)(*kids)
        return type(tree)(kids)
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` on each leaf of ``tree``, in a tree of its
    structure; ``path`` holds the keys down to the leaf: a dict's keys, a
    NamedTuple's field names, a list's or tuple's indices."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], (*path, k)) for k in tree}
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        keys = range(len(tree)) if fields is None else fields
        kids = [tree_map_with_path(fn, kid, (*path, k)) for k, kid in zip(keys, tree)]
        return type(tree)(kids) if fields is None else type(tree)(*kids)
    return fn(path, tree)


def tree_leaves_up_to(like: Any, tree: Any) -> list:
    """The subtrees of ``tree`` at the places of ``like``'s leaves, in leaf
    order (``tree`` has ``like``'s structure down to them; jax's
    ``flatten_up_to``)."""
    if like is None:
        return []
    kids = _children(like)
    if kids is None:
        return [tree]
    return [sub for kid, other in zip(kids, _children(tree), strict=True)
            for sub in tree_leaves_up_to(kid, other)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in leaf order)."""
    want = len(tree_leaves(like))
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} leaves for a tree of {want}")
    it = iter(leaves)

    def take(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            taken = {k: take(tree[k]) for k in sorted(tree)}
            return {k: taken[k] for k in tree}
        if isinstance(tree, (list, tuple)):
            kids = [take(kid) for kid in tree]
            return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(kids)
        return next(it)

    return take(like)
