"""Nested-dict helpers standing in for ``jax.tree`` on the port's state and
parameter trees (plain dicts whose leaves are numpy arrays or tensors)."""

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "tree_stack"]


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over structurally identical nested dicts."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        out = []
        for v in tree.values():
            out.extend(tree_leaves(v))
        return out
    return [tree]


def tree_stack(rows):
    """Stack a list of identical row trees into one tree of (k, ...) arrays."""
    import numpy as np

    return tree_map(lambda *xs: np.stack(xs), *rows)
