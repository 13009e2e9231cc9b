"""Minimal tree helpers for parameter and cache trees made of nested
dicts, lists and tuples (the port's stand-in for ``jax.tree_util``)."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping the dict/list/tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)



def tree_leaves(tree: Any) -> list:
    """Every leaf, in the order :func:`tree_map` visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
