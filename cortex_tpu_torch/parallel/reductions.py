"""Explicit mesh collectives for inference reductions.

The counterpart of ``cortex_tpu/parallel/reductions.py``: a quantity whose
leading (replica) axis is split over a mesh axis is reduced by a local sum
on each rank's block plus an ``all_reduce`` over that axis's group, and every
rank gets the result.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, all_reduce

__all__ = ["global_sum", "all_converged"]


def global_sum(x: torch.Tensor, mesh: Mesh, axis: str = "replica") -> torch.Tensor:
    """Sum a per-replica quantity (this rank's block of its leading axis, split
    over ``axis``) across the whole axis: local sum + ``all_reduce``.  Returns
    the same scalar (or ``x.shape[1:]``-shaped tensor) on every rank."""
    return all_reduce(torch.sum(x, dim=0), mesh, axis)


def all_converged(
    delta: torch.Tensor, tol: float, mesh: Mesh, axis: str = "replica"
) -> torch.Tensor:
    """True iff every replica's convergence measure is at most ``tol`` — a
    global AND, made as an ``all_reduce`` of the count of violations."""
    # ~(x <= tol) so NaN counts as a violation (NaN > tol is False).
    violations = torch.sum(~(delta <= tol), dtype=torch.int32)
    return all_reduce(violations, mesh, axis) == 0
