"""Carry model parameters, smoother operators, priors and states across from numpy.

These take what the JAX package produces, as plain Python or numpy values
(``dataclasses.asdict`` of a model, ``np.asarray`` of arrays), and return the
port's objects, so the two packages compute the same thing on the same
inputs.  They import neither package's arrays: numpy is the common ground.
Those that make tensors put them on the card unless the caller names
another ``device``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.hgf import HGF, HGFState
from .models.hgf_binary import BinaryHGF, BinaryHGFState
from .models.hmm import HMM, HMMVMPState
from .models.lgssm import LGSSM
from .ops.kernels_hgf import PARAMS as HGF_PARAMS

__all__ = [
    "binary_hgf_from_numpy",
    "binary_hgf_state_from_numpy",
    "hgf_from_numpy",
    "hgf_state_from_numpy",
    "hmm_from_numpy",
    "hmm_state_from_numpy",
    "lgssm_from_numpy",
    "operator_from_numpy",
    "prior_from_numpy",
]

_HGF_PARAMS = set(HGF_PARAMS)
_BINARY_HGF_PARAMS = {"kappa", "omega", "theta", "max_log_nu", "min_pi3", "max_mu3_step"}


def _floats(params: Mapping[str, object], known: set, model: str) -> dict:
    """``params`` as Python floats; raises on a key not in ``known``."""
    unknown = set(params) - known
    if unknown:
        raise ValueError(f"not {model} parameters: {sorted(unknown)}")
    return {k: float(v) for k, v in params.items()}


def lgssm_from_numpy(params: Mapping[str, object]) -> LGSSM:
    """The port's :class:`LGSSM` from ``{"A", "Q", "H", "R"}`` (for example
    ``dataclasses.asdict`` of the JAX ``LGSSM``).  Other keys raise."""
    return LGSSM(**_floats(params, {"A", "Q", "H", "R"}, "LGSSM"))


def operator_from_numpy(
    operator: Sequence[object], device="cuda"
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
    prior: Optional[Sequence[object]], dtype=torch.float32, device="cuda"
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


def hmm_from_numpy(params: Mapping[str, object], device="cuda") -> HMM:
    """The port's :class:`HMM` from ``{"K", "log_pi"}`` (for example
    ``dataclasses.asdict`` of the JAX ``HMM``), ``log_pi`` on ``device`` in
    its own dtype.  Other keys raise."""
    unknown = set(params) - {"K", "log_pi"}
    if unknown:
        raise ValueError(f"not HMM parameters: {sorted(unknown)}")
    return HMM(int(params["K"]), torch.tensor(np.asarray(params["log_pi"]), device=device))


def hmm_state_from_numpy(trans_alpha, emis_alpha, device="cuda") -> HMMVMPState:
    """An :class:`HMMVMPState` (for example the fields of a JAX
    ``HMMVMPState``) as tensors on ``device``, in the arrays' own dtype;
    ``emis_alpha`` may be ``None``."""
    def tensor(a):
        return None if a is None else torch.tensor(np.asarray(a), device=device)

    return HMMVMPState(tensor(trans_alpha), tensor(emis_alpha))


def hgf_from_numpy(params: Mapping[str, object]) -> HGF:
    """The port's :class:`HGF` from its parameters (for example
    ``dataclasses.asdict`` of the JAX ``HGF``), as Python floats.  Other keys
    raise."""
    return HGF(**_floats(params, _HGF_PARAMS, "HGF"))


def binary_hgf_from_numpy(params: Mapping[str, object]) -> BinaryHGF:
    """The port's :class:`BinaryHGF` from its parameters (for example
    ``dataclasses.asdict`` of the JAX ``BinaryHGF``).  Other keys raise."""
    return BinaryHGF(**_floats(params, _BINARY_HGF_PARAMS, "BinaryHGF"))


def hgf_state_from_numpy(state: Sequence[object], device="cuda") -> HGFState:
    """An :class:`HGFState` from its four arrays ``(mu1, pi1, mu2, pi2)``
    (for example a JAX ``HGFState``), on ``device`` in the arrays' own dtype."""
    return HGFState(*(torch.tensor(np.asarray(a), device=device) for a in state))


def binary_hgf_state_from_numpy(state: Sequence[object], device="cuda") -> BinaryHGFState:
    """A :class:`BinaryHGFState` from its four arrays ``(mu2, pi2, mu3,
    pi3)``, on ``device`` in the arrays' own dtype."""
    return BinaryHGFState(*(torch.tensor(np.asarray(a), device=device) for a in state))
