"""Paths over the port's trees: nested dicts and lists of tensors."""
from __future__ import annotations


def flatten(tree, prefix: str = "", seqs=(list, tuple)) -> dict:
    """{"a/b/0/c": tensor} over nested dicts and ``seqs``, in their
    order (a tree of specs passes ``seqs=(list,)``: a spec is a tuple)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, seqs):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k), seqs))
    return out


def at(tree, path: str):
    """The subtree at ``path`` ("layers/3/attn")."""
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def map_tree(fn, tree, prefix: str = ""):
    """A tree of the same structure with ``fn(path, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)
