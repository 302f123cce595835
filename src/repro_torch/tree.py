"""Minimal pytree helpers over nested dicts / lists / tuples of tensors.

Leaf order follows ``jax.tree_util.tree_flatten``: dict keys sorted,
sequences in order.  Keeping that order is what lets a flattened (n, D)
worker stack of the port compare column for column with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def tree_leaves(tree: PyTree) -> list:
    """The leaves in jax's flatten order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree: PyTree) -> list:
    """Each leaf's key path as ``jax.tree_util.keystr`` spells it
    (``"['blocks']['moe']['wi']"``, ``"[0]"``), in :func:`tree_leaves`'
    order."""
    if isinstance(tree, dict):
        return [f"[{k!r}]{rest}" for k in sorted(tree)
                for rest in tree_paths(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [f"[{i}]{rest}" for i, v in enumerate(tree)
                for rest in tree_paths(v)]
    return [""]


def tree_structure(tree: PyTree) -> PyTree:
    """A skeleton of ``tree`` with every leaf replaced by None."""
    return tree_map(lambda _: None, tree)


def tree_unflatten(structure: PyTree, leaves: list) -> PyTree:
    """Inverse of :func:`tree_leaves` for a skeleton of the same shape."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
