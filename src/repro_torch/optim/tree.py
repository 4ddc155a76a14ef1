"""Nested dicts of tensors, walked as the reference's ``jax.tree`` walks a
dict: keys in sorted order, depth first."""
from __future__ import annotations

from repro_torch.models.module import leaves


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the nodes at the same paths
    of ``rest`` (which may hold a dict where ``tree`` holds a leaf, as an
    optimizer's slots do: ``flatten_up_to``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in sorted key order, depth first."""
    return [x for _, x in leaves(tree)]
