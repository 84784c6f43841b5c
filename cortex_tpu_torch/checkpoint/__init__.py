"""Posterior-state checkpoint / resume.

All inference state of the port is a tree of tensors (filtering posteriors,
VMP states, natural parameters) in the sense of
:mod:`cortex_tpu_torch.utils.tree`, so persistence is generic, with the JAX
package's names and file layout:

- :func:`save` / :func:`restore` — single-file tree checkpoints (npz with a
  structure descriptor; no extra dependencies, works for the dists, the
  models' states and results, dicts, lists and tuples of them),
- :class:`CheckpointManager` — step-numbered checkpoints with retention, for
  periodic snapshots of long streaming runs.
"""

from .pytree_io import CheckpointManager, restore, save

__all__ = ["save", "restore", "CheckpointManager"]
