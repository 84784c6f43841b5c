"""Conjugate-computation variational inference (CVI), natural-gradient VI, in PyTorch.

The counterpart of ``cortex_tpu/ops/cvi.py`` (Khan & Lin 2017): each
non-conjugate site ``p(y_i | z_i)``, ``z_i = x_i·w``, is replaced by a
Gaussian pseudo-site whose natural parameters follow the natural gradient of
the ELBO,

    dm_i = E_q[∂_z log p(y_i|z_i)]          (Bonnet's identity)
    dv_i = ½ E_q[∂²_z log p(y_i|z_i)]       (Price's identity)
    λ₂ᵢ ← (1−ρ) λ₂ᵢ + ρ dv_i,   λ₁ᵢ ← (1−ρ) λ₁ᵢ + ρ (dm_i − 2 dv_i μ_i)

after which the global posterior is one conjugate Gaussian linear-model
update.  Expectations are Gauss–Hermite quadrature of the user's
``log_lik(z)`` and of its first and second derivatives, taken by
``torch.func.grad``.  The loop over iterations is a Python loop.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad

from ..utils.tree import as_float32_tensor, input_device
from .ep import _max_change, linear_posterior

__all__ = ["CVIResult", "cvi_linear_model"]


class CVIResult(NamedTuple):
    """Variational posterior over the weights plus the converged site
    naturals.  ``site_lam1``/``site_lam2``: per-site natural parameters of
    the Gaussian pseudo-observations; ``elbo_trace``: ELBO estimates per
    iteration (quadrature); ``delta``: last natural-parameter change
    (convergence diagnostic)."""

    mean: torch.Tensor
    cov: torch.Tensor
    site_lam1: torch.Tensor
    site_lam2: torch.Tensor
    elbo_trace: torch.Tensor
    delta: torch.Tensor


def cvi_linear_model(
    X,
    log_lik: Callable,
    prior_var: float = 1.0,
    n_iters: int = 60,
    step_size: float = 0.7,
    n_quad: int = 31,
    lam2_floor: float = 1e-8,
) -> CVIResult:
    """Natural-gradient VI for ``w ~ N(0, prior_var·I)``,
    ``y_i ~ p(·| x_i·w)`` with factorizing scalar sites.

    ``X``: ``(n, d)``; ``log_lik(z)`` maps ``(n, k)`` latent values to
    elementwise log-likelihoods (close over ``y``).  Conjugate (Gaussian)
    sites reach the exact posterior in one ρ=1 step; non-conjugate sites
    ascend the ELBO along the natural gradient.
    """
    X = as_float32_tensor(X, input_device(X))
    n, d = X.shape
    eye = torch.eye(d, dtype=X.dtype, device=X.device)

    nodes, weights = np.polynomial.hermite_e.hermegauss(n_quad)
    nodes = torch.tensor(nodes, dtype=X.dtype, device=X.device)
    qw = torch.tensor(weights / np.sqrt(2.0 * np.pi), dtype=X.dtype, device=X.device)

    # ``log_lik`` is elementwise over its (n, k) argument, so the gradient of
    # its sum IS the elementwise derivative (each output depends on one
    # input); iterating gives the elementwise second derivative.
    glog = grad(lambda z: torch.sum(log_lik(z)))
    hlog = grad(lambda z: torch.sum(glog(z)))

    def expectations(mu, var):
        sd = torch.sqrt(var)
        z = mu[:, None] + sd[:, None] * nodes[None, :]  # (n, k)
        e_ll = torch.sum(log_lik(z) * qw[None, :], dim=1)
        dm = torch.sum(glog(z) * qw[None, :], dim=1)  # Bonnet
        dv = 0.5 * torch.sum(hlog(z) * qw[None, :], dim=1)  # Price
        return e_ll, dm, dv

    def posterior(lam1, lam2):
        # Pseudo-precisions w̃ᵢ = −2λ₂ᵢ ≥ floor; pseudo-targets λ₁ᵢ.
        return linear_posterior(X, torch.clamp(-2.0 * lam2, min=lam2_floor), lam1, prior_var)

    lam1 = torch.zeros((n,), dtype=X.dtype, device=X.device)
    lam2 = torch.full((n,), -0.5 * lam2_floor, dtype=X.dtype, device=X.device)
    delta = torch.zeros((), dtype=X.dtype, device=X.device)
    elbos = []
    for _ in range(n_iters):
        m, L, sigma2 = posterior(lam1, lam2)
        mu = X @ m
        e_ll, dm, dv = expectations(mu, sigma2)
        lam2_new = (1.0 - step_size) * lam2 + step_size * torch.clamp(dv, max=-0.5 * lam2_floor)
        lam1_new = (1.0 - step_size) * lam1 + step_size * (dm - 2.0 * dv * mu)
        # ELBO (up to constants): E[log lik] − KL(q‖prior).
        logdet_Sinv = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        kl = 0.5 * (
            (m @ m) / prior_var
            + torch.trace(torch.cholesky_solve(eye, L)) / prior_var
            + logdet_Sinv
            + d * math.log(prior_var)
            - d
        )
        elbos.append(torch.sum(e_ll) - kl)
        delta = _max_change(lam1_new, lam1, lam2_new, lam2)
        lam1, lam2 = lam1_new, lam2_new
    m, L, _ = posterior(lam1, lam2)
    cov = torch.cholesky_solve(eye, L)
    trace = torch.stack(elbos) if elbos else torch.zeros(0, dtype=X.dtype, device=X.device)
    return CVIResult(m, cov, lam1, lam2, trace, delta)
