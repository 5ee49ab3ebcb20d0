"""Nested-dict parameter trees (the JAX package's pytrees of parameters).

Leaves are visited in sorted-key order, the order ``jax.tree_util`` uses
for dicts, so sums over a tree (the global grad norm) add the leaves in
the reference's order."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest`` (same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)
