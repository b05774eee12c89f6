"""Nested containers of tensors in the reference's leaf order.

The reference keeps parameters, optimizer state and error feedback as
pytrees and walks them with ``jax.tree_util``; the port keeps the same
nested dicts and NamedTuples and walks them here, in the same order:
dict keys sorted, NamedTuple fields in declaration order, tuple and list
items by position, ``None`` holding no leaf.  Anything else is a leaf.
:func:`keystr` spells a path as ``jax.tree_util.keystr`` does
(``.params['blocks']['attn']['wq']``), so a checkpoint's manifest names
its leaves as the reference's does.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Tuple[str, Any], ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x):
    """``[(path entry, child)]`` of a container, or None for a leaf."""
    if isinstance(x, dict):
        return [(("key", k), x[k]) for k in sorted(x)]
    if _is_namedtuple(x):
        return [(("attr", f), getattr(x, f)) for f in x._fields]
    if isinstance(x, (tuple, list)):
        return [(("index", i), v) for i, v in enumerate(x)]
    if x is None:
        return []
    return None


def _rebuild(x, values):
    if isinstance(x, dict):
        return dict(zip(sorted(x), values))
    if _is_namedtuple(x):
        return type(x)(*values)
    if isinstance(x, (tuple, list)):
        return type(x)(values)
    return None


# The walks below are module functions, not closures: a recursive closure
# refers to itself through its cell, and that cycle would keep the list of
# leaves it appends to (whole parameter trees) alive until the cyclic
# collector runs, long after the caller dropped them.

def _walk(x, path, out) -> None:
    kids = _children(x)
    if kids is None:
        out.append((path, x))
        return
    for entry, child in kids:
        _walk(child, path + (entry,), out)


def leaves_with_path(tree) -> List[Tuple[Path, Any]]:
    out: List[Tuple[Path, Any]] = []
    _walk(tree, (), out)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def keystr(path: Path) -> str:
    parts = []
    for kind, k in path:
        if kind == "attr":
            parts.append(f".{k}")
        else:
            parts.append(f"[{k!r}]")
    return "".join(parts)


def unflatten(tree, values) -> Any:
    """``tree``'s structure with its leaves replaced, in order, by
    ``values``."""
    it = iter(values)
    out = _build(tree, it)
    if next(it, _END) is not _END:
        raise ValueError("more values than leaves")
    return out


def _build(x, it):
    kids = _children(x)
    if kids is None:
        return next(it)
    if x is None:
        return None
    return _rebuild(x, [_build(c, it) for _, c in kids])


_END = object()


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (which must hold the same number of leaves, in the same order)."""
    flat = [leaves(t) for t in (tree,) + rest]
    n = len(flat[0])
    if any(len(f) != n for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
