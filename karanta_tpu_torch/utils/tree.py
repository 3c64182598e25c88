"""Nested-dict parameter trees, the port's stand-in for JAX pytrees.

Parameters keep the JAX package's layout: nested dicts whose leaves are
tensors, per-layer weights stacked on a leading layer axis, quantized leaves
as ``{"int8_q": int8, "scale": float32}`` dicts.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """Apply fn(leaf, path) to every non-dict leaf; path is the key tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(tree, path)


def layer_slice(tree: Any, i: int) -> Any:
    """Index every leaf of a stacked per-layer tree at layer i (a view)."""
    return tree_map(lambda leaf, _: leaf[i], tree)
