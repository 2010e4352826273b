"""Trees of tensors: nested dicts and lists, leaves in a fixed order."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """Leaves of a nested dict / list tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(leaves, like):
    """A flat list in :func:`tree_leaves` order -> a tree shaped like ``like``."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(like)
