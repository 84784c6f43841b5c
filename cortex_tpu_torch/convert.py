"""Carry model parameters, smoother operators and priors across from numpy.

These take what the JAX package produces, as plain Python or numpy values
(``dataclasses.asdict`` of a model, ``np.asarray`` of arrays), and return the
port's objects, so the two packages compute the same thing on the same
inputs.  They import neither package's arrays: numpy is the common ground.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.lgssm import LGSSM

__all__ = ["lgssm_from_numpy", "operator_from_numpy", "prior_from_numpy"]


def lgssm_from_numpy(params: Mapping[str, object]) -> LGSSM:
    """The port's :class:`LGSSM` from ``{"A", "Q", "H", "R"}`` (for example
    ``dataclasses.asdict`` of the JAX ``LGSSM``).  Other keys raise."""
    unknown = set(params) - {"A", "Q", "H", "R"}
    if unknown:
        raise ValueError(f"not LGSSM parameters: {sorted(unknown)}")
    return LGSSM(**{k: float(v) for k, v in params.items()})


def operator_from_numpy(
    operator: Sequence[object], device=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The smoother operator ``(S, c, v)`` of ``lgssm_smoother_operator`` as
    tensors on ``device``, in the arrays' own dtype."""
    S, c, v = (torch.tensor(np.asarray(a), device=device) for a in operator)
    T = S.shape[-1]
    if S.shape != (T, T) or c.shape != (T,) or v.shape != (T,):
        raise ValueError(
            f"operator must be (T, T), (T,), (T,); got {S.shape}, {c.shape}, {v.shape}"
        )
    return S, c, v


def prior_from_numpy(
    prior: Optional[Sequence[object]], dtype=torch.float32, device=None
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """A ``(mean, variance)`` prior as tensors (scalars or batch-shaped);
    ``None`` stays ``None``."""
    if prior is None:
        return None
    mean, var = prior
    return (
        torch.tensor(np.asarray(mean), dtype=dtype, device=device),
        torch.tensor(np.asarray(var), dtype=dtype, device=device),
    )
