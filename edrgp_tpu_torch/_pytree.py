"""Nested containers of tensors, walked in the JAX package's leaf order.

A tree is a dict, a tuple, a list, a named tuple (``SVGPState``,
``HMCState``, ``AdaptState``) or a leaf: a tensor, a numpy array or a
number; ``None`` holds no leaf.  Dict entries are visited in sorted key
order and the others in order, as ``jax.tree_util`` visits them, and each
leaf's path is written as ``jax.tree_util.keystr`` writes it (``['a']``,
``[0]``, ``.theta1``), so a checkpoint's leaves and keys are the same in
both packages.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flatten_with_paths", "leaves", "structure", "unflatten_like"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(path suffix, child)] of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in leaf order."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for key, child in children:
        out.extend(flatten_with_paths(child, prefix + key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def structure(tree) -> str:
    """The tree's shape as ``str(jax.tree_util.tree_structure(tree))``
    prints it (leaves as ``*``)."""
    def show(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {show(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            inner = ", ".join(show(v) for v in node)
            return f"CustomNode(namedtuple[{type(node).__name__}], [{inner}])"
        if isinstance(node, tuple):
            inner = ", ".join(show(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if isinstance(node, list):
            return "[" + ", ".join(show(v) for v in node) + "]"
        return "*"
    return f"PyTreeDef({show(tree)})"


def _like(value: np.ndarray, ref):
    """``value`` in the type, dtype and device of the leaf ``ref``."""
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(value).to(device=ref.device, dtype=ref.dtype)
    if isinstance(ref, np.ndarray):
        return value.astype(ref.dtype)
    if isinstance(ref, (bool, int, float, np.generic)):
        return type(ref)(value.item())
    return value


def unflatten_like(tree_like, values):
    """A tree of ``tree_like``'s structure whose leaves are ``values`` (in
    leaf order), each cast to the type, dtype and device of the leaf of
    ``tree_like`` it replaces."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return _like(next(it), node)

    return build(tree_like)
