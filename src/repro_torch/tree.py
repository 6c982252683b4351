"""Nested dict / list / tuple trees of tensors: the port's parameter and state trees.

The reference keeps its trees as JAX pytrees; the port's are plain containers, and
these helpers walk them in one fixed order (dict keys sorted, as JAX sorts them;
lists and tuples by position).  A leaf is anything that is not a dict, list or tuple.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["leaves", "leaves_with_paths", "map_leaves", "unflatten"]

Path = tuple[Any, ...]


def leaves_with_paths(
    tree: Any, prefix: Path = (), is_leaf: Callable[[Any], bool] | None = None
) -> Iterator[tuple[Path, Any]]:
    """(path, leaf) pairs in order; a path is the tuple of keys and indices.
    ``is_leaf`` marks nodes taken whole (a partition tuple), as jax's does."""
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,), is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,), is_leaf)
    else:
        yield prefix, tree


def leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None) -> list[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf=is_leaf)]


def map_leaves(
    fn: Callable[..., Any], tree: Any, *rest: Any, is_leaf: Callable[[Any], bool] | None = None
) -> Any:
    """``fn`` applied leafwise to ``tree`` and trees of the same structure
    (``is_leaf`` as in :func:`leaves_with_paths`, on ``tree``)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("trees of different lengths")
        out = [map_leaves(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten(structure: Any, new_leaves: list[Any]) -> Any:
    """A tree shaped like ``structure`` whose leaves, in order, are ``new_leaves``."""
    it = iter(new_leaves)

    def build(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the structure holds")
        return leaf

    out = build(structure)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()
