"""Nested parameter trees in `jax.tree_util`'s leaf order.

A tree is a dict (its keys in sorted order), a tuple or list (in order)
or a dataclass (in field order) of subtrees; anything else is a leaf.
The JAX package's checkpoints number their leaves ``a0, a1, …`` in this
order, and its Adam sums the gradient norm over the leaves in it, so
the port flattens the same way.
"""
from __future__ import annotations

import dataclasses


def _children(tree):
    """→ (names, subtrees) of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        names = sorted(tree)
        return names, [tree[k] for k in names]
    if isinstance(tree, (tuple, list)):
        return list(range(len(tree))), list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return names, [getattr(tree, k) for k in names]
    return None


def leaves_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in leaf order; a path joins the keys, indices and
    field names from the root with ``/``."""
    node = _children(tree)
    if node is None:
        return [(prefix, tree)]
    out = []
    for name, sub in zip(*node):
        out += leaves_with_paths(sub, f"{prefix}/{name}" if prefix
                                 else str(name))
    return out


def leaves(tree) -> list:
    """The leaves of ``tree`` in `jax.tree_util.tree_leaves` order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` (in leaf
    order) in place of its leaves."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        names, subs = kids
        built = [build(s) for s in subs]
        if isinstance(node, dict):
            return dict(zip(names, built))
        if isinstance(node, (tuple, list)):
            return type(node)(built)
        return dataclasses.replace(node, **dict(zip(names, built)))

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure → a tree of the
    first one's structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(t) for t in rest))])
