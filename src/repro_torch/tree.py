"""The part of ``jax.tree_util`` the port needs, for trees of nested dicts,
tuples and lists with tensors (or arrays) at the leaves.

Leaves come in JAX's order: a dict's keys sorted, a sequence's items in
order.  The optimizer's global norm sums the leaves in that order and the
checkpoint names each leaf by its path, so both agree with the JAX
package's.
"""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def leaves_with_paths(tree, is_leaf=None, prefix=()):
    """[(path, leaf)] in JAX's order; a path is a tuple of keys and
    indices.  ``is_leaf(node)`` true stops the descent at ``node``."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out += leaves_with_paths(sub, is_leaf, prefix + (key,))
    return out


def leaves(tree, is_leaf=None):
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf)]


def unflatten(like, values, is_leaf=None):
    """A tree of ``like``'s structure with ``values`` (in JAX's order) at
    its leaves."""
    it = iter(values)

    def build(node):
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}      # keep the caller's order
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than leaves")
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of the same structure, up to ``tree``'s leaves)."""
    flat = [leaves(tree, is_leaf)] + [
        [leaf for _, leaf in _matching(tree, r, is_leaf)] for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)], is_leaf)


def _matching(like, other, is_leaf):
    """``other``'s subtrees at ``like``'s leaf paths, in order."""
    out = []
    for path, _ in leaves_with_paths(like, is_leaf):
        node = other
        for key in path:
            node = node[key]
        out.append((path, node))
    return out
