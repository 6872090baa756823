"""Nested dicts of tensors as trees (the port's stand-in for the JAX
package's ``jax.tree_util`` over parameter pytrees). Leaves are visited
in sorted key order, as JAX flattens a dict."""
from __future__ import annotations

__all__ = ["flatten", "unflatten", "tree_map"]


def flatten(tree, prefix=()):
    """``[(path, leaf)]``, ``path`` the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def unflatten(items):
    """The nested dict of ``(path, leaf)`` pairs."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    flat = [flatten(t) for t in trees]
    return unflatten([(path, fn(*(f[i][1] for f in flat)))
                      for i, (path, _) in enumerate(flat[0])])
