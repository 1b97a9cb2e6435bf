"""Nests of dicts, lists, tuples and NamedTuples (the port's pytrees):
their leaves with JAX's key paths, and a map over them.

Dicts are walked in sorted key order, as ``jax.tree_util`` flattens them,
so a key path here names the same leaf as the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(key path, leaf) pairs; a key path is a tuple of dict keys, field
    names and list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from leaves_with_paths(getattr(tree, f), path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (which share ``tree``'s structure), into ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map_tree(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def get(tree, path: Tuple):
    for k in path:
        tree = getattr(tree, k) if _is_namedtuple(tree) else tree[k]
    return tree


def map_with_paths(fn: Callable, tree, path: Tuple = ()):
    """``fn(key path, leaf)`` over the leaves of ``tree``, into its
    structure."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)
