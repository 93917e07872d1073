"""Parameter trees: nested dicts and lists of tensors, walked in the
JAX package's leaf order (a dict's keys sorted, a list's in order), so
that a flattened port tree lines up with the reference's."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _items(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in order (None is no leaf)."""
    if _is_node(tree):
        return [x for _, v in _items(tree) for x in leaves(v)]
    return [] if tree is None else [tree]


def paths(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) pairs in leaf order: dict keys and list indices."""
    if _is_node(tree):
        return [pl for k, v in _items(tree) for pl in paths(v, prefix + (k,))]
    return [] if tree is None else [(prefix, tree)]


def map(fn: Callable, tree, *rest):  # noqa: A001 — jax.tree.map's name
    """``fn`` applied to each leaf of ``tree`` and the leaves at the same
    place in ``rest``, in a tree of the same structure (None stays)."""
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return None if tree is None else fn(tree, *rest)


def unflatten(template, flat: List[Any]):
    """A tree of ``template``'s structure whose leaves are ``flat``, in
    leaf order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return None if t is None else next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
