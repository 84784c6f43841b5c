"""Expectation propagation — parallel (batched-site) EP for linear models, in PyTorch.

The counterpart of ``cortex_tpu/ops/ep.py``: every site's cavity, tilted
moments and update at once per iteration (one gather → moment-match →
scatter), one d×d Cholesky per iteration, moment matching in closed form
(probit) or by Gauss–Hermite quadrature of a user log-likelihood.  The
loop over iterations is a Python loop.

Model:  w ~ N(0, prior_var · I),  z_i = x_i·w,  y_i ~ p(y_i | z_i).
EP sites are Gaussian approximations t_i(z_i) = N(z_i; ν_i/τ_i, 1/τ_i).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..dists.gaussian import _cholesky_nan, _device
from ..utils.tree import as_float32_tensor

__all__ = [
    "EPResult",
    "ep_linear_model",
    "probit_tilted_moments",
    "gauss_hermite_tilted",
]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class EPResult(NamedTuple):
    """Posterior over the weights plus the converged site parameters.

    ``mean``: ``(d,)``; ``cov``: ``(d, d)``; ``site_tau``/``site_nu``:
    ``(n,)`` natural parameters of each likelihood approximation;
    ``site_delta``: max site-parameter change in the last iteration
    (convergence diagnostic).
    """

    mean: torch.Tensor
    cov: torch.Tensor
    site_tau: torch.Tensor
    site_nu: torch.Tensor
    site_delta: torch.Tensor


def _norm_logpdf(t):
    return -0.5 * t * t - _HALF_LOG_2PI


def probit_tilted_moments(y) -> Callable:
    """Closed-form tilted moments for probit sites ``p(y|z) = Φ(y z)``,
    ``y ∈ {-1, +1}`` (Rasmussen & Williams eq. 3.58): exact, no quadrature."""
    y = as_float32_tensor(y)

    def moments(mu_cav, var_cav):
        s = torch.sqrt(1.0 + var_cav)
        t = y * mu_cav / s
        # φ(t)/Φ(t), computed in log space for stability in the tails.
        ratio = torch.exp(_norm_logpdf(t) - torch.special.log_ndtr(t))
        mean = mu_cav + y * var_cav * ratio / s
        var = var_cav - var_cav**2 * ratio * (t + ratio) / (1.0 + var_cav)
        return mean, var

    return moments


def hermite_e_rule(n_points: int, like: torch.Tensor):
    """Probabilists' Gauss–Hermite nodes and log weights of ``N(0, 1)``, as
    float32 (the JAX package's dtype) on ``like``'s device."""
    nodes, weights = np.polynomial.hermite_e.hermegauss(n_points)  # weight e^{-x²/2}
    logw = np.log(weights / np.sqrt(2.0 * np.pi))
    return (torch.tensor(nodes, dtype=torch.float32, device=like.device),
            torch.tensor(logw, dtype=torch.float32, device=like.device))


def gauss_hermite_tilted(log_lik: Callable, n_points: int = 31) -> Callable:
    """Tilted moments by Gauss–Hermite quadrature of an arbitrary scalar
    ``log_lik(z)`` (vectorized over sites): the generic route when no
    closed form exists.  ``log_lik`` receives ``z`` shaped ``(n_sites,
    n_points)`` and returns elementwise log-likelihoods."""

    def moments(mu_cav, var_cav):
        nodes, logw = hermite_e_rule(n_points, mu_cav)
        sd = torch.sqrt(var_cav)
        z = mu_cav[:, None] + sd[:, None] * nodes[None, :]  # (n, k)
        logp = logw[None, :] + log_lik(z)
        logZ = torch.logsumexp(logp, dim=1, keepdim=True)
        w = torch.exp(logp - logZ)
        mean = torch.sum(w * z, dim=1)
        var = torch.sum(w * (z - mean[:, None]) ** 2, dim=1)
        return mean, var

    return moments


def _max_change(a_new, a, b_new, b):
    return torch.maximum(torch.max(torch.abs(a_new - a)), torch.max(torch.abs(b_new - b)))


def linear_posterior(X, site_prec, site_target, prior_var):
    """The Gaussian posterior of ``w`` given Gaussian pseudo-sites on
    ``z = X w`` with precisions ``site_prec`` and natural targets
    ``site_target``: its mean ``(d,)``, the Cholesky factor of its precision
    and the marginal variances of every ``z_i`` (one factorization serves
    all three)."""
    d = X.shape[1]
    Sinv = torch.eye(d, dtype=X.dtype, device=X.device) / prior_var + X.T @ (site_prec[:, None] * X)
    L = _cholesky_nan(Sinv)
    m = torch.cholesky_solve((X.T @ site_target)[:, None], L)[:, 0]
    V = torch.cholesky_solve(X.T, L)  # (d, n) = S Xᵀ
    sigma2 = torch.sum(X * V.T, dim=1)  # diag(X S Xᵀ)
    return m, L, sigma2


def ep_linear_model(
    X,
    tilted_moments: Callable,
    prior_var: float = 1.0,
    n_iters: int = 30,
    damping: float = 0.8,
    tau_floor: float = 1e-8,
) -> EPResult:
    """Parallel EP posterior ``q(w) = N(mean, cov)`` for a Bayesian linear
    model with factorizing scalar likelihood sites.

    ``X``: ``(n, d)`` design matrix; ``tilted_moments(mu_cav, var_cav) ->
    (mean, var)`` moment-matches every site's tilted distribution at once
    (:func:`probit_tilted_moments` or :func:`gauss_hermite_tilted`).
    Conjugate (Gaussian) sites converge in one iteration to the exact
    posterior; non-conjugate sites typically need 10–30 damped iterations.
    """
    X = as_float32_tensor(X, _device(X))
    n, d = X.shape
    tau = torch.full((n,), tau_floor, dtype=X.dtype, device=X.device)
    nu = torch.zeros((n,), dtype=X.dtype, device=X.device)
    delta = torch.zeros((), dtype=X.dtype, device=X.device)
    for _ in range(n_iters):
        m, _, sigma2 = linear_posterior(X, tau, nu, prior_var)
        mu = X @ m
        # Cavity (floored: deleting a strong site from a tight marginal can
        # transiently produce a non-positive precision).
        tau_cav = torch.clamp(1.0 / sigma2 - tau, min=tau_floor)
        nu_cav = mu / sigma2 - nu
        mt, vt = tilted_moments(nu_cav / tau_cav, 1.0 / tau_cav)
        vt = torch.clamp(vt, min=1e-10)
        tau_new = torch.clamp(1.0 / vt - tau_cav, min=tau_floor)
        nu_new = mt / vt - nu_cav
        tau_next = (1.0 - damping) * tau + damping * tau_new
        nu_next = (1.0 - damping) * nu + damping * nu_new
        delta = _max_change(tau_next, tau, nu_next, nu)
        tau, nu = tau_next, nu_next
    m, L, _ = linear_posterior(X, tau, nu, prior_var)
    cov = torch.cholesky_solve(torch.eye(d, dtype=X.dtype, device=X.device), L)
    return EPResult(m, cov, tau, nu, delta)
