"""Hierarchical Gaussian filter, streaming/online filtering, in PyTorch.

The counterpart of ``cortex_tpu/models/hgf.py``: the 2-level continuous HGF
(Mathys et al. 2011), whose hidden state's volatility is itself a Gaussian
random walk,

    x2_t ~ N(x2_{t-1}, theta)
    x1_t ~ N(x1_{t-1}, exp(kappa*x2_t + omega))
    u_t  ~ N(x1_t, 1/pi_u)

with the closed-form precision-weighted prediction-error updates per
observation.  The filtering posterior is a small tuple of tensors, which is
what streams: :meth:`HGF.step` consumes one observation, :meth:`HGF.filter`
runs a whole series, and :func:`cortex_tpu_torch.parallel.stream_filter`
feeds chunks from the host while the card computes.  Every update is
elementwise: replicas batch along leading axes with one state each.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.kernels_hgf import ALL_TRACKS, PARAMS, hgf_filter_fused, hgf_update

__all__ = ["HGF", "HGFState", "HGFTrajectory"]

_METHODS = ("scan", "fused")


def _number_or_tensor(value):
    """A parameter as the model holds it: a tensor as given (so autograd can
    flow through it), anything else as a Python float."""
    return value if isinstance(value, torch.Tensor) else float(value)


class HGFState(NamedTuple):
    """Filtering posterior: means and precisions of both levels."""

    mu1: torch.Tensor
    pi1: torch.Tensor
    mu2: torch.Tensor
    pi2: torch.Tensor


class HGFTrajectory(NamedTuple):
    mu1: Optional[torch.Tensor]
    pi1: Optional[torch.Tensor]
    mu2: Optional[torch.Tensor]
    pi2: Optional[torch.Tensor]
    prediction_error: Optional[torch.Tensor]  # level-1 volatility PE (delta1)


class HGF(nn.Module):
    """2-level continuous HGF.

    ``kappa``/``omega`` couple level 2 to level-1 volatility; ``theta`` is
    the level-2 volatility; ``pi_u`` the observation precision.  The guards
    keep a streaming filter finite where the reference TAPAS implementation
    errors out on a negative precision: they bound the log-volatility, floor
    the level-2 precision and cap the level-2 step.

    Each parameter is a Python number or a tensor; tensors are kept as given
    (an ``nn.Parameter`` registers as one), so gradients flow through
    :meth:`log_likelihood` and the scan.  The module works on the device of
    its inputs.
    """

    def __init__(
        self,
        kappa=1.0,
        omega=-2.0,
        theta=0.05,
        pi_u=10.0,
        max_log_nu=20.0,
        min_pi2=1e-2,
        max_mu2_step=5.0,
    ):
        super().__init__()
        self.kappa = _number_or_tensor(kappa)
        self.omega = _number_or_tensor(omega)
        self.theta = _number_or_tensor(theta)
        self.pi_u = _number_or_tensor(pi_u)
        self.max_log_nu = _number_or_tensor(max_log_nu)
        self.min_pi2 = _number_or_tensor(min_pi2)
        self.max_mu2_step = _number_or_tensor(max_mu2_step)

    def params(self) -> dict:
        """The seven parameters by name, as the model holds them."""
        return {name: getattr(self, name) for name in PARAMS}

    def extra_repr(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.params().items())

    def init_state(
        self, batch_shape: Tuple[int, ...] = (), dtype=torch.float32, device="cuda"
    ) -> HGFState:
        """The zero state (mu = 0, pi = 1) of shape ``batch_shape``, on
        ``device`` (the card unless the caller asks for another)."""
        z = torch.zeros(batch_shape, dtype=dtype, device=device)
        return HGFState(z, torch.ones_like(z), z, torch.ones_like(z))

    def step(self, state: HGFState, u: torch.Tensor) -> Tuple[HGFState, torch.Tensor]:
        """One streaming update: observation(s) ``u`` → new state and the
        volatility prediction error ``delta1``."""
        *new_state, delta1 = hgf_update(*state, u, **self.params())
        return HGFState(*new_state), delta1

    def log_likelihood(self, u: torch.Tensor, state: Optional[HGFState] = None) -> torch.Tensor:
        """One-step-ahead predictive log likelihood Σ_t log N(u_t; μ̂1_t,
        1/π̂1_t + 1/π_u), shape ``u.shape[:-1]``: the fitting objective of
        HGF parameter estimation, differentiable in tensor parameters."""
        uT = u.movedim(-1, 0)
        if state is None:
            state = self.init_state(uT.shape[1:], u.dtype, u.device)
        lls = []
        for u_t in uT:
            mu1, pi1, mu2, _ = state
            log_nu = torch.clamp(self.kappa * mu2 + self.omega, -self.max_log_nu, self.max_log_nu)
            pihat1 = 1.0 / (1.0 / pi1 + torch.exp(log_nu))
            pred_var = 1.0 / pihat1 + 1.0 / self.pi_u
            lls.append(-0.5 * (torch.log(2.0 * math.pi * pred_var) + (u_t - mu1) ** 2 / pred_var))
            state, _ = self.step(state, u_t)
        return torch.stack(lls).sum(0)

    def filter(
        self,
        u: torch.Tensor,
        state: Optional[HGFState] = None,
        method: str = "scan",
        tracks: Optional[Sequence[str]] = None,
    ) -> Tuple[HGFState, HGFTrajectory]:
        """Filter a series ``u`` of shape ``(..., T)``; returns the final
        state and an :class:`HGFTrajectory` of the requested tracks (``None``
        in the slots of the others).

        ``tracks``: a subset of ``("mu1", "pi1", "mu2", "pi2", "delta1")``
        (default: all five).  Filtering-only callers pass ``tracks=()`` and
        read the final state.

        ``method="scan"``: a loop over T (any batch shape, any initial state,
        tensor parameters).  ``method="fused"`` (JAX calls it ``"pallas"``):
        the CUDA kernel :func:`~cortex_tpu_torch.ops.hgf_filter_fused`, the
        whole trajectory of every replica in one launch; it needs ``u`` of
        shape ``(R, T)``, the default initial state and parameters that need
        no gradient.
        """
        if method not in _METHODS:
            raise ValueError(f"Unknown method: {method!r} (expected one of {_METHODS})")
        tracks = ALL_TRACKS if tracks is None else tuple(tracks)

        def to_traj(values):
            by_name = dict(zip(tracks, values))
            return HGFTrajectory(*(by_name.get(n) for n in ALL_TRACKS))

        if method == "fused":
            if state is not None or u.dim() != 2:
                raise ValueError(
                    "method='fused' requires u of shape (R, T) and the default initial state"
                )
            finals, values = hgf_filter_fused(u, **self.params(), tracks=tracks)
            return HGFState(*finals), to_traj(values)

        uT = u.movedim(-1, 0)
        if state is None:
            state = self.init_state(uT.shape[1:], u.dtype, u.device)
        emitted = {name: [] for name in tracks}
        for u_t in uT:
            state, delta1 = self.step(state, u_t)
            step = dict(zip(ALL_TRACKS, (*state, delta1)))
            for name, out in emitted.items():
                out.append(step[name])
        return state, to_traj(tuple(torch.stack(emitted[n], dim=-1) for n in tracks))
