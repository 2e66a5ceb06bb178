"""Minimal pytree helpers over NamedTuples, tuples, lists, dicts and tensors.

Leaf order is that of ``jax.tree.flatten``: NamedTuple/tuple/list fields in
order, dict keys sorted, ``None`` contributes no leaf. The checkpoint bridge
(``io/checkpoint.py``) depends on this order.
"""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves):
    """Rebuild ``template``'s structure from ``leaves`` (flatten order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_stack(trees):
    """Stack a list of same-structure trees along a new leading axis."""
    import torch

    return tree_map(lambda *xs: torch.stack(xs), *trees)
