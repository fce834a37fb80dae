"""Pytree helpers over the port's state: nested dicts, tuples, lists and
NamedTuples of tensors, walked in ``jax.tree_util``'s order (dict keys
sorted, sequences and NamedTuple fields in order, ``None`` an empty
subtree), so that a leaf's position and path match the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_paths", "tree_unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key string, child) pairs of an inner node, as jax's
    ``tree_flatten_with_path`` names them: ``['k']`` for a dict key,
    ``[i]`` for a sequence index, ``.name`` for a NamedTuple field; None
    for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the structure of ``tree`` is kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(
            *(tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
              for f in tree._fields)
        )
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)
        )
    return fn(tree, *rest)


def _flatten(tree, prefix: Tuple[str, ...], out: List[Tuple[str, Any]]):
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        out.append(("/".join(prefix), tree))
        return
    for key, child in kids:
        _flatten(child, prefix + (key,), out)


def tree_paths(tree) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in jax's order, each path the string the
    JAX package's checkpoint writes: the keys of
    ``tree_flatten_with_path`` joined by ``/``, e.g.
    ``"[1]/.m/['embed']/['tok']"``."""
    out: List[Tuple[str, Any]] = []
    _flatten(tree, (), out)
    return out


def tree_leaves(tree) -> list:
    """The leaves in jax's order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in jax's order."""
    it = iter(leaves)

    def rebuild(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(rebuild(getattr(node, f)) for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(c) for c in node)
        return next(it)

    out = rebuild(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
