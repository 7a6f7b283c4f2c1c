"""Parameter trees as the JAX package walks them: nested dicts (and
tuples), their leaves in ``jax.tree`` order -- a dict's keys sorted, a
tuple's items by index -- whatever order the dicts were built in.  The
optimizer's global norm sums the leaves in this order, and a checkpoint
names each leaf by its path, as ``jax.tree_util.tree_flatten_with_path``
does."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree`` order; a path holds dict keys
    and tuple indices."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, values):
    """A tree of ``like``'s structure whose leaves are ``values``, taken in
    ``jax.tree`` order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)
