"""Gaussian-process classification via parallel EP (probit likelihood), in PyTorch.

The counterpart of ``cortex_tpu/models/gpc.py``: the latent function gets a
GP prior, EP sites are moment-matched in closed form (Rasmussen & Williams
§3.6, the parallel variant: every site updates at once per iteration, one
n×n Cholesky each), and the predictive class probability integrates the
latent Gaussian through the probit exactly.  With a linear kernel this
reduces to Bayesian linear probit classification.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Tuple, Union

import torch

from ..dists.gaussian import _cholesky_nan
from ..ops.ep import _max_change, probit_tilted_moments
from ..utils.tree import as_float32_tensor
from .gp import _KERNELS, _points, _solve_lower

__all__ = ["GPClassifier", "GPCPosterior"]


class GPCPosterior(NamedTuple):
    """Converged EP site parameters plus the predictive closure."""

    site_tau: torch.Tensor
    site_nu: torch.Tensor
    latent_mean: torch.Tensor  # (n,) posterior mean of f at the training inputs
    predict_fn: Callable
    site_delta: torch.Tensor

    def latent(self, Xs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Latent predictive ``q(f*) = N(μ*, σ*²)`` at ``(m, d)`` inputs."""
        return self.predict_fn(Xs)

    def predict_proba(self, Xs) -> torch.Tensor:
        """``p(y=+1 | x*)`` — exact probit integral over the latent."""
        mu, var = self.predict_fn(Xs)
        return torch.special.ndtr(mu / torch.sqrt(1.0 + var))

    def predict(self, Xs) -> torch.Tensor:
        """Hard labels in {-1, +1}."""
        p = self.predict_proba(Xs)
        return torch.where(p >= 0.5, 1.0, -1.0).to(p.dtype)


@dataclasses.dataclass(frozen=True)
class GPClassifier:
    """Binary GP classification ``y ∈ {-1,+1}``, ``p(y|f) = Φ(y f)``,
    ``f ~ GP(0, k)``.

    ``kernel``: name (``"rbf"``/``"matern32"``/``"matern52"``/``"linear"``)
    or a callable ``k(a, b, lengthscale, variance)``.
    """

    kernel: Union[str, Callable] = "rbf"
    lengthscale: float = 1.0
    variance: float = 1.0
    n_iters: int = 40
    damping: float = 0.7
    jitter: float = 1e-6

    def _k(self):
        if self.kernel == "linear":
            return lambda a, b: self.variance * (a @ b.T)
        k = _KERNELS[self.kernel] if isinstance(self.kernel, str) else self.kernel
        return partial(k, lengthscale=self.lengthscale, variance=self.variance)

    def fit(self, X, y) -> GPCPosterior:
        """``X``: ``(n, d)``; ``y``: ``(n,)`` in {-1, +1}."""
        X = _points(X)
        y = as_float32_tensor(y, X.device)
        n = X.shape[0]
        eye = torch.eye(n, dtype=X.dtype, device=X.device)
        K = self._k()(X, X) + self.jitter * (1.0 + self.variance) * eye
        tilted = probit_tilted_moments(y)
        tau_floor = 1e-8

        def posterior(tau, nu):
            # Σ = K − K√τ B⁻¹ √τ K with B = I + √τ K √τ (RW eq. 3.56).
            sq = torch.sqrt(tau)
            L = _cholesky_nan(eye + sq[:, None] * K * sq[None, :])
            V = _solve_lower(L, sq[:, None] * K)
            Sigma_diag = torch.diagonal(K) - torch.sum(V * V, dim=0)
            mu = K @ nu - V.T @ (V @ nu)
            return mu, Sigma_diag, L

        tau = torch.full((n,), tau_floor, dtype=X.dtype, device=X.device)
        nu = torch.zeros((n,), dtype=X.dtype, device=X.device)
        delta = torch.zeros((), dtype=X.dtype, device=X.device)
        for _ in range(self.n_iters):
            mu, sd, _ = posterior(tau, nu)
            tau_cav = torch.clamp(1.0 / sd - tau, min=tau_floor)
            nu_cav = mu / sd - nu
            mt, vt = tilted(nu_cav / tau_cav, 1.0 / tau_cav)
            vt = torch.clamp(vt, min=1e-10)
            tau_new = torch.clamp(1.0 / vt - tau_cav, min=tau_floor)
            nu_new = mt / vt - nu_cav
            tau_next = (1.0 - self.damping) * tau + self.damping * tau_new
            nu_next = (1.0 - self.damping) * nu + self.damping * nu_new
            delta = _max_change(tau_next, tau, nu_next, nu)
            tau, nu = tau_next, nu_next
        mu, _, L = posterior(tau, nu)

        # Predictive (RW eq. 3.60-3.61): f̄* = k*ᵀ(K+Σ̃)⁻¹μ̃ with μ̃=ν̃/τ̃,
        # computed through the same B factorization:
        #   (K+Σ̃)⁻¹μ̃ = ν̃ − √τ B⁻¹ √τ K ν̃.
        sq = torch.sqrt(tau)
        alpha = nu - sq * torch.cholesky_solve((sq * (K @ nu))[:, None], L)[:, 0]
        return self.posterior(X, tau, nu, mu, L, alpha, delta)

    def posterior(self, X, tau, nu, latent_mean, L, alpha, delta) -> GPCPosterior:
        """The posterior from its arrays: training inputs ``(n, d)``, the site
        parameters, the latent mean at the inputs, the Cholesky factor of
        ``B = I + √τ K √τ``, the predictive weights ``(K+Σ̃)⁻¹μ̃`` and the
        last site change."""
        k = self._k()
        sq = torch.sqrt(tau)

        def predict(Xs):
            Xs = _points(Xs, X.device)
            Ks = k(X, Xs)  # (n, m)
            mean = Ks.T @ alpha
            V = _solve_lower(L, sq[:, None] * Ks)
            if self.kernel == "linear":
                kss = self.variance * torch.sum(Xs * Xs, dim=-1)
            elif isinstance(self.kernel, str):
                kss = self.variance * torch.ones(Xs.shape[0], dtype=X.dtype, device=X.device)
            else:
                kss = torch.diagonal(k(Xs, Xs))
            var = torch.clamp(kss - torch.sum(V * V, dim=0), min=1e-10)
            return mean, var

        return GPCPosterior(tau, nu, latent_mean, predict, delta)
