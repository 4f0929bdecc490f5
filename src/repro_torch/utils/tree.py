"""Minimal pytree helpers over dicts, lists, tuples and NamedTuples.

The port keeps the JAX package's parameter layout (nested lists and
dicts of arrays, ``EntityState``/``TrainState`` NamedTuples), so it needs
the few tree operations JAX provides.  ``None`` is an empty subtree, as
in JAX: it has no leaves and maps to ``None``.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree: Any) -> list:
    """Leaves in a fixed order (dict keys sorted, as JAX orders them)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for x in tree for l in tree_leaves(x)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over ``tree`` and trees of the same shape."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, x, *(r[i] for r in rest))
                            for i, x in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten_like(tree: Any, leaves: list) -> Any:
    """Rebuild ``tree``'s structure from ``leaves`` in tree_leaves order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_slice(tree: Any, start: int, stop: int | None = None) -> Any:
    """Slice every leaf's leading dim: used to split stacked layer params."""
    return tree_map(lambda x: x[start:stop], tree)
