"""Parameter trees: nested dicts and lists of tensors (the port's
parameters, gradients and optimizer state), the port's stand-in for JAX's
pytrees.  A leaf's key is its path joined by "/" (``blocks/3/mixer/wq``).
"""
from __future__ import annotations

from typing import Callable, Iterator


def named_leaves(tree, prefix: str = "") -> Iterator[tuple]:
    """(key, leaf) of every leaf, in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def map_tree(fn: Callable, tree):
    """A tree of the same structure with ``fn(leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)
