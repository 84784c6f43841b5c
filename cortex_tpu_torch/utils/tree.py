"""A small tree helper over nested containers with tensors as leaves.

The compiled path stacks, slices and concatenates whole distributions at
once, as the JAX package does with pytrees.  A tree here is built of
dataclass instances (their ``init`` fields, in order, the class kept),
tuples, lists and dicts (keys in sorted order).  Anything else is a leaf.

Stacking and concatenation raise :class:`ValueError` on mismatched
structures, shapes or devices, as ``jnp.stack`` and ``jax.tree_util`` do:
the executor's fallbacks catch that type.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "tree_flatten",
    "tree_unflatten",
    "tree_leaves",
    "tree_structure",
    "tree_map",
    "as_float32_tensor",
    "stack",
    "concatenate",
]

_LEAF = ("leaf",)


def _node(tree: Any) -> Tuple[Any, List[Any]]:
    """``(aux, children)`` of one node, or ``(_LEAF, [])`` for a leaf."""
    if isinstance(tree, torch.Tensor):
        return _LEAF, []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree) if f.init)
        return ("dataclass", type(tree), names), [getattr(tree, n) for n in names]
    if isinstance(tree, tuple):
        return ("tuple", len(tree)), list(tree)
    if isinstance(tree, list):
        return ("list", len(tree)), list(tree)
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys), [tree[k] for k in keys]
    return _LEAF, []


def _build(aux: Tuple, children: List[Any]) -> Any:
    kind = aux[0]
    if kind == "dataclass":
        return aux[1](**dict(zip(aux[2], children)))
    if kind == "tuple":
        return tuple(children)
    if kind == "list":
        return list(children)
    return dict(zip(aux[1], children))


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """The leaves of ``tree`` in order, and its structure (hashable)."""
    aux, children = _node(tree)
    if aux is _LEAF:
        return [tree], _LEAF
    leaves: List[Any] = []
    defs = []
    for child in children:
        sub_leaves, sub_def = tree_flatten(child)
        leaves.extend(sub_leaves)
        defs.append(sub_def)
    return leaves, (aux, tuple(defs))


def tree_unflatten(treedef: Any, leaves: Sequence[Any]) -> Any:
    """Rebuild a tree of structure ``treedef`` from ``leaves`` in order."""
    it = iter(leaves)

    def build(d):
        if d == _LEAF:
            return next(it)
        aux, defs = d
        return _build(aux, [build(c) for c in defs])

    return build(treedef)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_structure(tree: Any) -> Any:
    return tree_flatten(tree)[1]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and, position by position, of the
    trees in ``rest``, which must have the same structure (else
    :class:`ValueError`)."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_def = tree_flatten(other)
        if o_def != treedef:
            raise ValueError(
                f"tree structures differ: {_describe(treedef)} and {_describe(o_def)}"
            )
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def _describe(treedef: Any) -> str:
    if treedef == _LEAF:
        return "leaf"
    aux, defs = treedef
    name = aux[1].__name__ if aux[0] == "dataclass" else aux[0]
    return f"{name}({', '.join(_describe(d) for d in defs)})"


def as_float32_tensor(x: Any, device=None) -> torch.Tensor:
    """``x`` as a tensor, as ``jnp.asarray`` makes it with 64-bit types off:
    a tensor stays as it is; Python and numpy floats become float32 and
    integers int32, on ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    t = torch.as_tensor(np.asarray(x))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    elif t.dtype == torch.int64:
        t = t.to(torch.int32)
    return t if device is None else t.to(device)


def _tensors(xs: Sequence[Any]) -> List[torch.Tensor]:
    if all(isinstance(x, torch.Tensor) for x in xs):
        return list(xs)
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return [as_float32_tensor(x, device) for x in xs]


def stack(xs: Sequence[Any], dim: int = 0) -> torch.Tensor:
    """``torch.stack`` that raises :class:`ValueError` on mismatched shapes
    or devices (``torch.stack`` raises :class:`RuntimeError`)."""
    xs = _tensors(xs)
    shapes = {tuple(x.shape) for x in xs}
    if len(shapes) > 1:
        raise ValueError(f"all stacked tensors must have the same shape, got {sorted(shapes)}")
    try:
        return torch.stack(xs, dim)
    except RuntimeError as e:
        raise ValueError(str(e)) from e


def concatenate(xs: Sequence[Any], dim: int = 0) -> torch.Tensor:
    """``torch.cat`` that raises :class:`ValueError` on mismatched shapes or
    devices."""
    xs = _tensors(xs)
    try:
        return torch.cat(xs, dim)
    except RuntimeError as e:
        raise ValueError(str(e)) from e
