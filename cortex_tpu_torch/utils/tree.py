"""A small tree helper over nested containers with tensors as leaves.

The compiled path stacks, slices and concatenates whole distributions at
once, as the JAX package does with pytrees.  A tree here is built of
dataclass instances (their ``init`` fields, in order, the class kept),
named tuples (their fields, the class kept), tuples, lists and dicts (keys in
sorted order); ``None`` is a node with no children, as in
``jax.tree_util``.  Anything else is a leaf.

Stacking and concatenation raise :class:`ValueError` on mismatched
structures, shapes or devices, as ``jnp.stack`` and ``jax.tree_util`` do:
the executor's fallbacks catch that type.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from . import spans

__all__ = [
    "keystr",
    "tree_flatten",
    "tree_flatten_with_path",
    "treedef_str",
    "tree_unflatten",
    "tree_leaves",
    "tree_structure",
    "tree_map",
    "DEFAULT_DEVICE",
    "input_device",
    "as_float32_tensor",
    "as_tensors",
    "as_values",
    "as_operands",
    "to_tensor",
    "stack",
    "concatenate",
]

_LEAF = ("leaf",)


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _node(tree: Any) -> Tuple[Any, List[Any]]:
    """``(aux, children)`` of one node, or ``(_LEAF, [])`` for a leaf."""
    if isinstance(tree, torch.Tensor):
        return _LEAF, []
    if tree is None:
        return ("none",), []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree) if f.init)
        return ("dataclass", type(tree), names), [getattr(tree, n) for n in names]
    if _is_namedtuple(tree):
        return ("namedtuple", type(tree), type(tree)._fields), list(tree)
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
    if kind == "none":
        return None
    if kind == "dataclass":
        return aux[1](**dict(zip(aux[2], children)))
    if kind == "namedtuple":
        return aux[1](*children)
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


def _child_keys(aux: Tuple, n: int) -> List[str]:
    """The key of each child of a node in ``jax.tree_util.keystr``'s style."""
    kind = aux[0]
    if kind in ("dataclass", "namedtuple"):
        return [f".{name}" for name in aux[2]]
    if kind == "dict":
        return [f"[{key!r}]" for key in aux[1]]
    return [f"[{i}]" for i in range(n)]


def tree_flatten_with_path(tree: Any) -> Tuple[List[Tuple[Tuple[str, ...], Any]], Any]:
    """``([(path, leaf), ...], treedef)``: each leaf with its path from the
    root, a tuple of keys in ``jax.tree_util``'s style (``['key']`` for a
    dict entry, ``.name`` for a dataclass or named-tuple field, ``[i]`` for
    a sequence item); :func:`keystr` joins them."""
    aux, children = _node(tree)
    if aux is _LEAF:
        return [((), tree)], _LEAF
    pairs: List[Tuple[Tuple[str, ...], Any]] = []
    defs = []
    for key, child in zip(_child_keys(aux, len(children)), children):
        sub_pairs, sub_def = tree_flatten_with_path(child)
        pairs.extend(((key, *path), leaf) for path, leaf in sub_pairs)
        defs.append(sub_def)
    return pairs, (aux, tuple(defs))


def keystr(path: Sequence[str]) -> str:
    """A path of :func:`tree_flatten_with_path` as one string, as
    ``jax.tree_util.keystr`` writes it (``"['a'].mu1[0]"``)."""
    return "".join(path)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in order (``jax.tree_util.tree_leaves``)."""
    return tree_flatten(tree)[0]


def tree_structure(tree: Any) -> Any:
    """The structure of ``tree``, as :func:`tree_flatten` gives it
    (``jax.tree_util.tree_structure``)."""
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
                f"tree structures differ: {treedef_str(treedef)} and {treedef_str(o_def)}"
            )
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def treedef_str(treedef: Any) -> str:
    """A structure as text, in the style of ``str(jax.tree_util.PyTreeDef)``:
    ``*`` a leaf, ``{'a': *, 'b': (*, *)}``, ``[*]``, ``None``, and
    ``CustomNode(Gaussian[()], [*, *])`` or ``CustomNode(namedtuple[HGFState],
    [*, ...])`` for a class."""
    def text(d):
        if d == _LEAF:
            return "*"
        aux, defs = d
        parts = [text(c) for c in defs]
        kind = aux[0]
        if kind == "none":
            return "None"
        if kind == "dataclass":
            return f"CustomNode({aux[1].__name__}[()], [{', '.join(parts)}])"
        if kind == "namedtuple":
            return f"CustomNode(namedtuple[{aux[1].__name__}], [{', '.join(parts)}])"
        if kind == "tuple":
            return f"({parts[0]},)" if len(parts) == 1 else f"({', '.join(parts)})"
        if kind == "list":
            return f"[{', '.join(parts)}]"
        return "{" + ", ".join(f"{k!r}: {p}" for k, p in zip(aux[1], parts)) + "}"

    return f"PyTreeDef({text(treedef)})"


# Where inputs that are not tensors go when nothing else names a device: the
# card.  Not an option of any entry point; a test on a machine without a card
# sets it to "cpu", to feed the port the very arrays it feeds the JAX package.
DEFAULT_DEVICE = "cuda"

# numpy's 64-bit types and what ``jnp.asarray`` makes of them with 64-bit
# types off.
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32, np.dtype(np.complex128): np.complex64}


def input_device(*xs: Any, device=None, default=None):
    """The device that the inputs among ``xs`` which are not tensors go to:
    ``device`` if the caller named one; else that of the first tensor among
    ``xs``; else ``default`` (the device of a model's buffers, or the one an
    object was built for); else :data:`DEFAULT_DEVICE`, the card.  Never the
    CPU unless one of these names it: without a card, a copy there raises."""
    if device is not None:
        return device
    first = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    if first is not None:
        return first
    return DEFAULT_DEVICE if default is None else default


def as_float32_tensor(x: Any, device=None) -> torch.Tensor:
    """``x`` as a tensor, as ``jnp.asarray`` makes it with 64-bit types off:
    a tensor stays as it is, with its dtype and device; numpy arrays of any
    stride, numpy and Python scalars and lists become float32 (floats),
    int32 (integers) or bool, on ``device`` (left where numpy puts them, on
    the host, when it is ``None``)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    # A copy, in row-major order: the tensor owns its memory, as a JAX array
    # does, whatever the strides or the writability of ``x``.
    t = torch.from_numpy(np.array(a, dtype=_NARROW.get(a.dtype, a.dtype), order="C"))
    return t if device is None else spans.h2d(t.to(device))


def to_tensor(x: Any, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype, device)`` that also takes a numpy array of
    any stride (one with a negative stride is copied in row-major order
    first, which ``torch.as_tensor`` refuses to do)."""
    if isinstance(x, np.ndarray) and any(s < 0 for s in x.strides):
        x = np.array(x, order="C")
    return torch.as_tensor(x, dtype=dtype, device=device)


def as_tensors(*xs: Any, device=None, default=None) -> Tuple[Any, ...]:
    """``xs`` as an entry point takes them: every array among them (numpy
    arrays of any stride, numpy scalars, lists) made a tensor by
    :func:`as_float32_tensor` on the one device that :func:`input_device`
    picks for ``xs``, ``device`` and ``default``; tensors, Python numbers and
    ``None`` as given."""
    dev = None
    out = []
    for x in xs:
        if not (x is None or isinstance(x, (torch.Tensor, bool, int, float))):
            dev = input_device(*xs, device=device, default=default) if dev is None else dev
            x = as_float32_tensor(x, dev)
        out.append(x)
    return tuple(out)


def as_values(*xs: Any, device=None, like: Any = ()) -> Tuple[Any, ...]:
    """``xs`` as the JAX package's first ``jnp`` call takes them in a
    distribution's constructor or method: every one that is not a tensor
    (numpy arrays of any stride, numpy and Python scalars) made a tensor by
    :func:`as_float32_tensor` on the device that :func:`input_device` picks
    for ``device``, ``xs`` and the leaves of ``like`` (the object's other
    fields); tensors and ``None`` as given."""
    if all(isinstance(x, torch.Tensor) for x in xs):
        return xs
    dev = input_device(*xs, *tree_leaves(like), device=device)
    return tuple(x if x is None else as_float32_tensor(x, dev) for x in xs)


def as_operands(*xs: Any) -> Tuple[Any, ...]:
    """``xs`` as JAX's plain arithmetic takes them: as given when none is a
    tensor (numpy computes them, in float64, as it does under JAX), else
    by :func:`as_tensors` (numpy arrays join the first tensor's device;
    Python numbers stay numbers, which torch takes as JAX takes them)."""
    if not any(isinstance(x, torch.Tensor) for x in xs):
        return xs
    return as_tensors(*xs)


def _tensors(xs: Sequence[Any]) -> List[torch.Tensor]:
    if all(isinstance(x, torch.Tensor) for x in xs):
        return list(xs)
    device = input_device(*xs)
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
