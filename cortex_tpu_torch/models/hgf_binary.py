"""Binary hierarchical Gaussian filter (3-level), in PyTorch.

The counterpart of ``cortex_tpu/models/hgf_binary.py``: binary observations
``u ∈ {0,1}`` arise from a probability ``sigmoid(x2)``; ``x2`` is a Gaussian
random walk whose volatility is governed by a third level ``x3``.
Closed-form precision-weighted updates per trial, the same batching as
:class:`~cortex_tpu_torch.models.HGF` and the same numerical guards.  It has
no kernel: :meth:`BinaryHGF.filter` is a loop over trials.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from .hgf import _number_or_tensor

__all__ = ["BinaryHGF", "BinaryHGFState", "BinaryHGFTrajectory"]


class BinaryHGFState(NamedTuple):
    mu2: torch.Tensor
    pi2: torch.Tensor
    mu3: torch.Tensor
    pi3: torch.Tensor


class BinaryHGFTrajectory(NamedTuple):
    p_hat: torch.Tensor  # predicted outcome probability before each trial
    mu2: torch.Tensor
    pi2: torch.Tensor
    mu3: torch.Tensor
    pi3: torch.Tensor


class BinaryHGF(nn.Module):
    """3-level binary HGF with coupling and volatility parameters, each a
    Python number or a tensor (kept as given).  The module works on the
    device of its inputs."""

    def __init__(
        self,
        kappa=1.0,
        omega=-2.0,
        theta=0.05,
        max_log_nu=20.0,
        min_pi3=1e-2,
        max_mu3_step=5.0,
    ):
        super().__init__()
        self.kappa = _number_or_tensor(kappa)
        self.omega = _number_or_tensor(omega)
        self.theta = _number_or_tensor(theta)
        self.max_log_nu = _number_or_tensor(max_log_nu)
        self.min_pi3 = _number_or_tensor(min_pi3)
        self.max_mu3_step = _number_or_tensor(max_mu3_step)

    def extra_repr(self) -> str:
        names = ("kappa", "omega", "theta", "max_log_nu", "min_pi3", "max_mu3_step")
        return ", ".join(f"{n}={getattr(self, n)}" for n in names)

    def init_state(
        self, batch_shape: Tuple[int, ...] = (), dtype=torch.float32, device="cuda"
    ) -> BinaryHGFState:
        """The zero state (mu = 0, pi = 1) of shape ``batch_shape``, on
        ``device`` (the card unless the caller asks for another)."""
        z = torch.zeros(batch_shape, dtype=dtype, device=device)
        return BinaryHGFState(z, torch.ones_like(z), z, torch.ones_like(z))

    def step(
        self, state: BinaryHGFState, u: torch.Tensor
    ) -> Tuple[BinaryHGFState, torch.Tensor]:
        """One trial: binary observation(s) ``u`` → new state, predicted p."""
        mu2, pi2, mu3, pi3 = state

        # Level-1 prediction (before seeing u).
        muhat1 = torch.sigmoid(mu2)
        delta1 = u - muhat1

        # Level-2 update.
        log_nu = torch.clamp(self.kappa * mu3 + self.omega, -self.max_log_nu, self.max_log_nu)
        nu = torch.exp(log_nu)
        pihat2 = 1.0 / (1.0 / pi2 + nu)
        pi2_new = pihat2 + muhat1 * (1.0 - muhat1)
        mu2_new = mu2 + delta1 / pi2_new

        # Level-3 (volatility) update.
        w2 = nu * pihat2
        delta2 = (1.0 / pi2_new + (mu2_new - mu2) ** 2) * pihat2 - 1.0
        pihat3 = 1.0 / (1.0 / pi3 + self.theta)
        pi3_new = pihat3 + 0.5 * self.kappa**2 * w2 * (w2 + (2.0 * w2 - 1.0) * delta2)
        pi3_new = torch.clamp(pi3_new, min=self.min_pi3)
        mu3_step = torch.clamp(
            0.5 * self.kappa * (w2 / pi3_new) * delta2, -self.max_mu3_step, self.max_mu3_step
        )
        mu3_new = mu3 + mu3_step

        return BinaryHGFState(mu2_new, pi2_new, mu3_new, pi3_new), muhat1

    def filter(
        self, u: torch.Tensor, state: Optional[BinaryHGFState] = None
    ) -> Tuple[BinaryHGFState, BinaryHGFTrajectory]:
        """Filter a trial series ``u`` of shape ``(..., T)``, as float32."""
        u = torch.as_tensor(u, dtype=torch.float32)
        uT = u.movedim(-1, 0)
        if state is None:
            state = self.init_state(uT.shape[1:], u.dtype, u.device)
        traj = []
        for u_t in uT:
            state, p_hat = self.step(state, u_t)
            traj.append((p_hat, *state))
        return state, BinaryHGFTrajectory(*(torch.stack(a, dim=-1) for a in zip(*traj)))
