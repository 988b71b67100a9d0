"""Trees of tensors: nested dicts, tuples, lists and NamedTuples, flattened
in ``jax.tree``'s order.

A dict's leaves come in the order of its sorted keys and a NamedTuple's in
field order, as in JAX; ``None`` is an empty node.  Everything else is a
leaf.  The order is part of the checkpoint format (leaf ``i`` is stored as
``leaf_{i:05d}``) and the order in which a global norm sums, so every tree
walk of the port goes through this module.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map"]

_LEAF = object()


def _walk(node: Any, leaves: list) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        keys = sorted(node)
        return (dict, keys, [_walk(node[k], leaves) for k in keys])
    if isinstance(node, (tuple, list)):
        return (type(node), None, [_walk(v, leaves) for v in node])
    leaves.append(node)
    return _LEAF


def _build(d: Any, leaves: Iterator) -> Any:
    if d is None:
        return None
    if d is _LEAF:
        return next(leaves)
    kind, keys, children = d
    values = [_build(c, leaves) for c in children]
    if kind is dict:
        return dict(zip(keys, values))
    if hasattr(kind, "_fields"):                           # NamedTuple
        return kind(*values)
    return kind(values)


# Module-level recursion, not nested closures: a closure that calls itself
# is a reference cycle, which would keep the leaves (a train step's
# parameters and moments) alive until the garbage collector runs.
def tree_flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)``; :func:`tree_unflatten` inverts it."""
    leaves: list = []
    treedef = _walk(tree, leaves)
    return leaves, treedef


def tree_unflatten(treedef: Any, leaves: list) -> Any:
    return _build(treedef, iter(leaves))


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map: {len(o)} leaves against "
                             f"{len(leaves)}")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
