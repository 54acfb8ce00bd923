"""Parameter and optimizer trees, flattened in ``jax.tree.flatten``'s order.

The JAX package keeps its state as pytrees of nested dicts and NamedTuples,
and its checkpoints store one file per leaf, numbered in flatten order.  The
port keeps the same trees of tensors, and flattens them the same way so that
a checkpoint written by either package restores in the other:

* a dict's values in the order of its sorted keys;
* a tuple's or NamedTuple's (``AdamWState``: step, m, v) in field order;
* depth-first; anything else is a leaf (the trees here hold no lists).
"""

from __future__ import annotations

from typing import Any, Callable


def _children(node):
    """(kind, keys or None, children) of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", keys, [node[k] for k in keys]
    if isinstance(node, tuple):
        return type(node), None, list(node)
    return None


def flatten(tree) -> tuple[list, Any]:
    """(leaves, structure); ``unflatten(structure, leaves)`` rebuilds the tree."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _walk(node, leaves: list):
    """``node``'s structure, its leaves appended to ``leaves``.  A module-level
    function, not a closure that calls itself: such a closure is a reference
    cycle that would hold ``leaves`` (tensors) until the cyclic collector runs."""
    inner = _children(node)
    if inner is None:
        leaves.append(node)
        return None
    kind, keys, kids = inner
    return kind, keys, [_walk(k, leaves) for k in kids]


def unflatten(structure, leaves):
    it = iter(leaves)
    out = _build(structure, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def _build(spec, it):
    if spec is None:
        return next(it)
    kind, keys, kids = spec
    values = [_build(k, it) for k in kids]
    if kind == "dict":
        return dict(zip(keys, values))
    if kind is tuple:
        return tuple(values)
    return kind(*values)  # a NamedTuple


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in a tree of the same structure."""
    flat, spec = flatten(tree)
    return unflatten(spec, [fn(x) for x in flat])


def describe(structure) -> str:
    """A ``PyTreeDef(...)``-like string of a structure (informational only)."""

    def show(spec):
        if spec is None:
            return "*"
        kind, keys, kids = spec
        parts = [show(k) for k in kids]
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {p}" for k, p in zip(keys, parts)) + "}"
        if kind is tuple:
            return "(" + ", ".join(parts) + ")"
        return f"CustomNode(namedtuple[{kind.__name__}], [{', '.join(parts)}])"

    return f"PyTreeDef({show(structure)})"
