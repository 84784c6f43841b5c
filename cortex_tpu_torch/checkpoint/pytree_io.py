"""Dependency-free tree checkpointing (npz + structure descriptor).

The file layout is the JAX package's: one ``leaf_{i}`` entry a leaf, in the
order of :func:`~cortex_tpu_torch.utils.tree.tree_flatten`, and the
structure's text as ``__treedef_repr__``.  numpy has no bfloat16, so the port
adds ``__dtypes__``, each leaf's dtype; a bfloat16 leaf is stored as its raw
16 bits and restored bit for bit.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional

import numpy as np
import torch

from ..utils.tree import tree_flatten, tree_unflatten, treedef_str

__all__ = ["save", "restore", "CheckpointManager"]


def _text(array: np.ndarray) -> str:
    return bytes(array).decode()


def _encode(text: str) -> np.ndarray:
    return np.frombuffer(text.encode(), dtype=np.uint8)


def _to_numpy(leaf: Any):
    """A leaf as a host numpy array and its dtype's name (``""`` for a leaf
    that is not a tensor)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), ""
    host = leaf.detach().cpu()
    name = str(host.dtype).removeprefix("torch.")
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy(), name
    return host.numpy(), name


def _from_numpy(array: np.ndarray, dtype: str, like: Any):
    """A saved leaf in its saved dtype, on the device of ``like``'s leaf; a
    numpy array where that leaf is not a tensor (as the JAX package restores
    every leaf)."""
    if not isinstance(like, torch.Tensor):
        return array
    if dtype == "bfloat16":
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16).to(like.device)
    return torch.from_numpy(array).to(like.device)


def save(path: str, tree: Any) -> None:
    """Serialize a tree of tensors to ``path`` (.npz).

    Leaves on any device go through the host.  The structure's text is stored
    for validation beside the leaves in order; restore requires a matching
    ``like`` tree (structure comes from code, data from the file).  The file
    is written under a name of this process and moved into place, so a
    reader never sees it half written."""
    leaves, treedef = tree_flatten(tree)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"], dtype = _to_numpy(leaf)
        dtypes.append(dtype)
    arrays["__treedef_repr__"] = _encode(treedef_str(treedef))
    arrays["__dtypes__"] = _encode(json.dumps(dtypes))
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def restore(path: str, like: Any) -> Any:
    """Load a tree saved by :func:`save`.  ``like`` provides the structure;
    each leaf comes back in its saved dtype on the device of ``like``'s
    leaf.  A different structure raises ``ValueError``."""
    with np.load(path) as data:
        saved_repr = _text(data["__treedef_repr__"])
        leaves_like, treedef = tree_flatten(like)
        if treedef_str(treedef) != saved_repr:
            raise ValueError(
                "Checkpoint structure mismatch:\n"
                f"  saved:    {saved_repr}\n  expected: {treedef_str(treedef)}"
            )
        dtypes = json.loads(_text(data["__dtypes__"]))
        leaves = [_from_numpy(data[f"leaf_{i}"], dtypes[i], leaf)
                  for i, leaf in enumerate(leaves_like)]
    return tree_unflatten(treedef, leaves)


class CheckpointManager:
    """Step-numbered checkpoints with retention.

    ``manager.save(step, state)`` writes ``ckpt_{step}.npz`` in ``directory``
    and prunes to the newest ``max_to_keep``; ``manager.restore(like)`` loads
    the latest.
    """

    _PATTERN = re.compile(r"ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = self._PATTERN.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> str:
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        save(path, tree)
        steps = self._steps()
        for old in steps[: -self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"ckpt_{old}.npz"))
        return path

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        return restore(os.path.join(self.directory, f"ckpt_{step}.npz"), like)
