"""Nested-dict parameter trees, the port's stand-in for JAX pytrees.

Parameters keep the JAX package's layout: nested dicts whose leaves are
tensors, per-layer weights stacked on a leading layer axis, quantized leaves
as ``{"int8_q": int8, "scale": float32}`` dicts. The classifiers' trees also
hold lists (one entry per stage or block), as the JAX ones do; a list's
entries are keyed by their index in paths.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """Apply fn(leaf, path) to every leaf that is not a dict or a list; path
    is the key tuple (list indices as ints)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(tree, path)


def unbind_layers(tree: Any, n: int) -> list:
    """Per-layer views of a stacked tree, split once with ``torch.unbind``.

    The backward of ``unbind`` stacks the layers' gradients into one buffer,
    where indexing each layer would make every layer's backward write a
    zero-filled gradient of the whole stack (``chip_smoke.py`` times both)."""
    if isinstance(tree, dict):
        per = {k: unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    layers = torch.unbind(tree, 0)
    if len(layers) != n:
        raise ValueError(f"stacked leaf has {len(layers)} layers, not {n}")
    return list(layers)


def flatten_tree(tree: Any, prefix: str = "") -> dict:
    """Nested dicts and lists -> {"a/0/c": leaf}, in the tree's key order."""
    if isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for key, value in tree.items():
        flat.update(flatten_tree(value, f"{prefix}/{key}" if prefix else key))
    return flat


def unflatten_tree(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dicts (inverse of flatten_tree for trees
    without lists)."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree
