"""Nested-dict trees walked in JAX's flatten order.

The port keeps params, optimizer state and batches as nested dicts of
tensors, JAX's trees. ``jax.tree.flatten`` visits dict keys in sorted
order, depth first, and an empty dict holds no leaf; ``flatten`` here
does the same, so a sum over leaves adds in JAX's order and a
checkpoint's keys come out in JAX's order (``checkpoint/checkpoint.py``).
"""

from __future__ import annotations


def flatten(tree, prefix=()):
    """``[(path, leaf), ...]`` in JAX's order: dict keys sorted, depth
    first; ``path`` is the tuple of keys from the root."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in flatten(tree)]


def map_tree(fn, tree, *rest):
    """``fn(leaf, *leaves at the same path of rest)`` over every leaf,
    keeping the dict structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """``tree``'s structure with its leaves replaced, in JAX's order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out
