"""Switching linear Gaussian state-space model (SLDS) — IMM filtering, in PyTorch.

The counterpart of ``cortex_tpu/models/slds.py``.  A discrete regime
``s_t ~ Π[s_{t-1}]`` selects per-regime dynamics

    x_t = A[s] x_{t-1} + N(0, Q[s]),    y_t = H[s] x_t + N(0, R[s]).

Exact inference is exponential in T (the mixture over regime paths), so the
filter is the interacting-multiple-model (IMM) one: K Gaussian components
and the regime probabilities are carried, and the regime mixture is
moment-matched at every step.  The loop over time updates the K regimes of
every replica at once (leading replica axes of ``y``).  K = 1 reduces to the
exact Kalman filter.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from ..ops.chains import scalar_kalman_update
from ..utils.tree import as_float32_tensor, as_tensors, input_device

__all__ = ["SLDS", "SLDSBeliefs"]


class SLDSBeliefs(NamedTuple):
    """Filtered beliefs of a switching LGSSM.

    ``mean``/``variance``: moment-matched state beliefs, shape ``(..., T)``;
    ``regime_probs``: ``(..., T, K)`` filtered p(s_t | y_{1:t});
    ``loglik``: ``(...,)`` data log evidence (exact within the ADF).
    """

    mean: torch.Tensor
    variance: torch.Tensor
    regime_probs: torch.Tensor
    loglik: torch.Tensor


def _sample_categorical(generator: torch.Generator, cdf: torch.Tensor) -> torch.Tensor:
    """One draw per row of the CDFs ``cdf (..., K)`` (cumulative sums of the
    probabilities: callers take them once from the model's rows, since a scan
    over a short last axis costs the card far more than the draw) by inverting
    each at a uniform from ``generator``: int64 indices of shape
    ``cdf.shape[:-1]``."""
    u = torch.rand(cdf.shape[:-1], generator=generator, device=cdf.device, dtype=cdf.dtype)
    return torch.clamp((u[..., None] >= cdf).sum(-1), max=cdf.shape[-1] - 1)


class SLDS(nn.Module):
    """Scalar-state switching LGSSM.

    ``Pi``: ``(K, K)`` regime transition matrix (rows sum to 1, ``Pi[i, j] =
    p(s_t = j | s_{t-1} = i)``); ``A, Q, H, R``: ``(K,)`` per-regime
    coefficients; ``prior``: ``(mean, var)`` on ``x_1``; ``regime_prior``:
    ``(K,)`` p(s_1) (uniform when None).  The tensors are buffers: the model
    computes on the device it was moved to, which must be that of its tensor
    inputs.  Arrays that are not tensors become float32 buffers on the
    device of the tensors among them, or on the card; ``y`` that is not a
    tensor goes to the buffers' device.
    """

    def __init__(
        self,
        Pi,
        A,
        Q,
        H,
        R,
        prior: Tuple[float, float] = (0.0, 10.0),
        regime_prior=None,
    ):
        super().__init__()
        dev = input_device(Pi, A, Q, H, R, regime_prior)
        for name, value in (("Pi", Pi), ("A", A), ("Q", Q), ("H", H), ("R", R)):
            self.register_buffer(name, as_float32_tensor(value, dev))
        K = self.Pi.shape[0]
        w0 = (torch.full((K,), 1.0 / K, dtype=self.Pi.dtype, device=self.Pi.device)
              if regime_prior is None else as_float32_tensor(regime_prior, dev))
        self.register_buffer("w0", w0)
        self.prior = (float(prior[0]), float(prior[1]))

    @property
    def K(self) -> int:
        return self.Pi.shape[0]

    def extra_repr(self) -> str:
        return f"K={self.K}, prior={self.prior}"

    def forward(self, y: torch.Tensor) -> SLDSBeliefs:
        """Same as :meth:`filter`."""
        return self.filter(y)

    def filter(self, y: torch.Tensor) -> SLDSBeliefs:
        """IMM filtering over ``y`` shaped ``(..., T)`` (leading replica axes).
        Per step: regime mixing (moment matching), per-regime Kalman time and
        measurement update, regime reweighting by the predictive
        likelihoods."""
        y, = as_tensors(y, default=self.Pi.device)
        Pi, A, Q, H, R = self.Pi, self.A, self.Q, self.H, self.R
        K = self.K
        yT = y.movedim(-1, 0)[..., None]  # (T, ..., 1) broadcast against K
        batch = yT.shape[1:-1]
        log_Pi = torch.log(Pi)

        pm = torch.full(batch + (K,), self.prior[0], dtype=y.dtype, device=y.device)
        pv = torch.full(batch + (K,), self.prior[1], dtype=y.dtype, device=y.device)
        logw = torch.log(self.w0).expand(batch + (K,))

        def measurement(m_pred, v_pred, obs, logw_pred):
            m, v, loglik_k = scalar_kalman_update(obs, m_pred, v_pred, H, R)
            joint = logw_pred + loglik_k
            step_ll = torch.logsumexp(joint, dim=-1)
            return m, v, joint - step_ll[..., None], step_ll

        def moments(m, v, logw):
            w = torch.exp(logw)
            mean = torch.sum(w * m, dim=-1)
            var = torch.sum(w * (v + (m - mean[..., None]) ** 2), dim=-1)
            return mean, var, w

        # t = 1: no transition — measurement-update the prior directly.
        m, v, logw, loglik = measurement(pm, pv, yT[0], logw)
        mean, var, w = moments(m, v, logw)
        means, varis, ws = [mean], [var], [w]
        for obs in yT[1:]:
            # Mixing (interacting) step.
            log_joint = logw[..., :, None] + log_Pi  # (..., k, j)
            logw_pred = torch.logsumexp(log_joint, dim=-2)  # (..., j)
            mu = torch.exp(log_joint - logw_pred[..., None, :])  # μ_{k|j}
            m0 = torch.einsum("...kj,...k->...j", mu, m)
            v0 = torch.einsum("...kj,...k->...j", mu, v) + torch.einsum(
                "...kj,...kj->...j", mu, (m[..., :, None] - m0[..., None, :]) ** 2
            )
            # Per-regime time update.
            m_pred = A * m0
            v_pred = A * A * v0 + Q
            m, v, logw, step_ll = measurement(m_pred, v_pred, obs, logw_pred)
            loglik = loglik + step_ll
            mean, var, w = moments(m, v, logw)
            means.append(mean)
            varis.append(var)
            ws.append(w)
        return SLDSBeliefs(
            torch.stack(means, dim=-1), torch.stack(varis, dim=-1), torch.stack(ws, dim=-2),
            loglik)

    def log_evidence(self, y: torch.Tensor) -> torch.Tensor:
        """ADF log p(y_{1:T}) per replica, shape ``y.shape[:-1]``."""
        return self.filter(y).loglik

    def sample(
        self, generator: torch.Generator, T: int, batch_shape: Tuple[int, ...] = ()
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Simulate ``(s, x, y)``: regimes ``batch_shape + (T,)`` int32,
        states and observations ``batch_shape + (T,)`` in the model's dtype,
        on the model's device (the generator's must match)."""
        Pi, A, Q, H, R = self.Pi, self.A, self.Q, self.H, self.R
        batch = tuple(batch_shape)
        device, dtype = Pi.device, Pi.dtype
        cdf_Pi = torch.cumsum(Pi, dim=-1)
        s = _sample_categorical(generator, torch.cumsum(self.w0, dim=-1).expand(batch + (self.K,)))
        x = self.prior[0] + self.prior[1] ** 0.5 * torch.randn(
            batch, generator=generator, device=device, dtype=dtype)
        wn = torch.randn((T,) + batch, generator=generator, device=device, dtype=dtype)
        vn = torch.randn((T,) + batch, generator=generator, device=device, dtype=dtype)
        ss, xs, ys = [], [], []
        for t in range(T):
            if t:  # x_1 is the prior draw, in the first regime
                s = _sample_categorical(generator, cdf_Pi[s])
                x = A[s] * x + torch.sqrt(Q[s]) * wn[t]
            ss.append(s)
            xs.append(x)
            ys.append(H[s] * x + torch.sqrt(R[s]) * vn[t])
        # Indexing takes int64 regimes: they are cast once, at the end.
        return torch.stack(ss, -1).to(torch.int32), torch.stack(xs, -1), torch.stack(ys, -1)
