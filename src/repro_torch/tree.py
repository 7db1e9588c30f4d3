"""Trees of tensors: nested dicts, tuples, lists and NamedTuples, walked as
``jax.tree_util`` walks them.

Dict keys are visited in sorted order, so :func:`leaves` lists a tree in
``jax.tree.leaves`` order: a sum over the leaves (``optim.adamw``'s
global norm) adds them in the reference's order.  A leaf's path joins its
keys with ``/``, as the reference's checkpoint manager does: a dict key,
a sequence index, or ``.name`` for a NamedTuple field (``jax``'s
``GetAttrKey``).  ``None`` is an empty subtree.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key string, child) pairs in visiting order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) for every leaf, in ``jax.tree.leaves`` order."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from leaves_with_path(v, f"{prefix}/{k}" if prefix else k)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure) -> a tree of that structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` (in
    :func:`leaves` order); dicts come back with their keys sorted."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)
