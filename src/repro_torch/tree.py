"""Nested dicts of tensors as the reference's pytrees: its parameter,
optimizer and train-state trees are dicts all the way down."""

from __future__ import annotations

import torch


def tree_leaves_with_path(tree, prefix: str = "") -> list[tuple]:
    """(name, leaf) pairs in `jax.tree_util.tree_flatten_with_path` order:
    dict keys sorted, a leaf's name its keys joined by "/" (the checkpoint
    store's names, e.g. "opt/m/layers/attn/wq")."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_with_path(
            tree[k], f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves in `jax.tree.leaves` order: dict keys sorted."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and of the same-shaped `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves) -> dict:
    """`tree`'s structure (and key order) with `leaves`, given in
    `tree_leaves` order, in place of its leaves."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return next(it)
    return walk(tree)


def tree_unzip(tree, n: int) -> tuple:
    """A tree whose leaves are n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tree


def tree_map_with_path(fn, tree, *rest, prefix: str = ""):
    """`fn(name, leaf, *rest_leaves)` over the leaves of `tree` and of the
    same-shaped `rest`, names as in `tree_leaves_with_path`
    (`jax.tree_util.tree_map_with_path`), each under `prefix`."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      prefix=f"{prefix}/{k}" if prefix
                                      else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)
