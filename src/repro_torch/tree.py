"""Trees: nested dicts, lists and tuples whose other values are leaves.

The port's parameters, optimizer state and checkpointed state are such
trees (the JAX package's pytrees).  Leaves are walked in the JAX
package's order: dict keys sorted, sequences in order.  A tuple subclass
with ``_fields`` (a ``NamedTuple``) is rebuilt as its own type.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(node) -> "list | None":
    """The node's children in leaf order, or None for a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        by_key = dict(zip(sorted(node), children))
        return {k: by_key[k] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def tree_leaves(tree) -> list:
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(k) for k in kids])

    out = build(like)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    flat = [tree_leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError(f"trees differ in leaf count: "
                         f"{[len(f) for f in flat]}")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def tree_paths(tree, prefix: str = "") -> list:
    """Each leaf's path (``layers/0/rwkv/wr``), in leaf order."""
    kids = _children(tree)
    if kids is None:
        return [prefix]
    keys = sorted(tree) if isinstance(tree, dict) else range(len(kids))
    return [p for k, kid in zip(keys, kids)
            for p in tree_paths(kid, f"{prefix}/{k}" if prefix else str(k))]


def leaves_at(tree, like) -> list:
    """``tree``'s subtrees at ``like``'s leaf positions, in leaf order
    (a spec tree's tuples at the parameters' leaves)."""
    kids = _children(like)
    if kids is None:
        return [tree]
    sub = [tree[k] for k in sorted(like)] if isinstance(like, dict) \
        else list(tree)
    return [x for s, k in zip(sub, kids) for x in leaves_at(s, k)]
