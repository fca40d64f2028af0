"""Nested containers of tensors (the port's pytrees), walked in the
reference's leaf order.

A tree is a dict, list, tuple or ``NamedTuple`` of trees, ``None`` (no
leaf) or a leaf (anything else).  Dicts are walked in sorted key order,
as ``jax.tree_util`` flattens them, so the leaves of a parameter dict,
of the optimizer state and of a checkpoint come in one order on both
sides: the reference's where the structure is the same.
"""
from __future__ import annotations


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    out = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        elif isinstance(node, (list, tuple)):
            for item in node:
                walk(item)
        else:
            out.append(node)

    walk(tree)
    return out


def unflatten(example, new_leaves) -> object:
    """A tree shaped as ``example`` holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if _is_namedtuple(node):
            return type(node)(*[build(item) for item in node])
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return next(it)

    out = build(example)
    if next(it, None) is not None:
        raise ValueError("more leaves than the example tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its shape."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*args) for args in zip(leaves(tree),
                                                      *others)])


def structure(tree):
    """A JSON-able description of ``tree``'s containers (leaves as
    ``None``), for checkpoint metadata."""
    if tree is None:
        return {"none": None}
    if isinstance(tree, dict):
        return {"dict": {str(k): structure(tree[k]) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        kind = ("namedtuple" if _is_namedtuple(tree)
                else type(tree).__name__)
        return {kind: [structure(item) for item in tree]}
    return None
