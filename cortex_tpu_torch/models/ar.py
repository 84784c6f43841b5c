"""Autoregressive model family: conjugate Bayesian AR(p) + latent-AR smoothing, in PyTorch.

The counterpart of ``cortex_tpu/models/ar.py``:

- :class:`BayesianAR` — the observed-series case ``y_t = Σ_k w_k y_{t-k} + ε``:
  the conjugate Normal–Inverse-Gamma posterior on the lag design (shared
  with :func:`~cortex_tpu_torch.models.glm.nig_fit`), batched over replica
  series, and k-step predictive means by the companion map.
- :func:`latent_ar_smooth` — ``x_t`` AR(p) observed in Gaussian noise,
  lowered to a companion-form vector LGSSM and smoothed by the associative
  scans of :func:`~cortex_tpu_torch.ops.chains_mv.mv_lgssm_smooth`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..dists.gaussian import _device
from ..ops.chains_mv import MvChainMarginals, mv_lgssm_smooth
from ..utils.tree import as_float32_tensor
from .glm import NIGPosterior, nig_fit

__all__ = ["ARPosterior", "BayesianAR", "companion_matrix", "latent_ar_smooth"]

#: The AR posterior *is* the shared Normal–Inverse-Gamma posterior on the
#: lag design (``models.glm.nig_fit``).
ARPosterior = NIGPosterior


def companion_matrix(coeffs) -> torch.Tensor:
    """``(..., p) -> (..., p, p)`` companion form: first row = coefficients,
    subdiagonal identity.  ``x_t = [w·lags, shift]``."""
    coeffs = as_float32_tensor(coeffs, _device(coeffs))
    p = coeffs.shape[-1]
    lower = torch.eye(p, dtype=coeffs.dtype, device=coeffs.device)[:-1]
    lower = lower.expand(tuple(coeffs.shape[:-1]) + (p - 1, p))
    return torch.cat([coeffs[..., None, :], lower], dim=-2)


def _lag_matrix(y: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., T) -> ((..., T-p, p), (..., T-p))`` design/targets.  Column k
    holds lag k+1 (most recent lag first), matching companion ordering."""
    T = y.shape[-1]
    X = torch.stack([y[..., p - 1 - k : T - 1 - k] for k in range(p)], dim=-1)
    return X, y[..., p:]


@dataclasses.dataclass(frozen=True)
class BayesianAR:
    """Conjugate Bayesian AR(p): ``y_t ~ N(Σ_k w_k y_{t-k}, σ²)`` with the
    Normal–Inverse-Gamma prior ``w|σ² ~ N(0, σ² prior_scale·I)``,
    ``σ² ~ InvGamma(a0, b0)``."""

    p: int = 1
    prior_scale: float = 100.0
    a0: float = 2.0
    b0: float = 1.0

    def fit(self, y) -> ARPosterior:
        """Exact posterior from a ``(..., T)`` series (leading axes = replica
        series, each fit independently in one batched solve)."""
        y = as_float32_tensor(y, _device(y))
        X, t = _lag_matrix(y, self.p)
        return nig_fit(X, t, self.prior_scale, self.a0, self.b0)

    def predict(self, y, posterior: Optional[ARPosterior] = None, horizon: int = 1
                ) -> torch.Tensor:
        """Posterior-mean forecast ``(..., horizon)`` by iterating the
        companion map at the posterior coefficient mean."""
        y = as_float32_tensor(y, _device(y))
        post = posterior if posterior is not None else self.fit(y)
        A = companion_matrix(post.mean)
        state = torch.flip(y[..., -self.p :], dims=[-1])  # most recent first
        preds = []
        for _ in range(horizon):
            state = (A @ state[..., None])[..., 0]
            preds.append(state[..., 0])
        if not preds:
            return torch.zeros(tuple(state.shape[:-1]) + (0,), dtype=y.dtype, device=y.device)
        return torch.stack(preds, dim=-1)


def latent_ar_smooth(
    y,
    coeffs,
    process_noise: float,
    obs_noise: float,
    prior_var: float = 10.0,
) -> MvChainMarginals:
    """Exact marginals of a latent AR(p) chain observed in Gaussian noise.

    ``x_t = Σ_k c_k x_{t-k} + N(0, process_noise)``;
    ``y_t = x_t + N(0, obs_noise)``; ``y``: ``(..., T)``.  Lowers to the
    companion-form LGSSM and runs the time-parallel smoother; the returned
    ``mean[..., t, 0]`` / ``cov[..., t, 0, 0]`` are the marginals of ``x_t``.
    """
    dev = _device(y, coeffs)
    y = as_float32_tensor(y, dev)
    coeffs = as_float32_tensor(coeffs, dev)
    p = coeffs.shape[-1]
    A = companion_matrix(coeffs)
    eye = torch.eye(p, dtype=coeffs.dtype, device=dev)
    e1 = eye[0]
    Q = process_noise * torch.outer(e1, e1) + 1e-9 * eye
    H = e1[None, :]
    R = torch.tensor([[obs_noise]], dtype=coeffs.dtype, device=dev)
    m0 = torch.zeros((p,), dtype=coeffs.dtype, device=dev)
    return mv_lgssm_smooth(y[..., None], A, Q, H, R, (m0, prior_var * eye))
