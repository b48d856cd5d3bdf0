"""Paths over the port's trees: nested dicts and lists of tensors."""
from __future__ import annotations


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/0/c": tensor} over nested dicts and lists, in their order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def map_tree(fn, tree, prefix: str = ""):
    """A tree of the same structure with ``fn(path, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)
