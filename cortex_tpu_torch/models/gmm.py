"""Gaussian mixture model — structured VMP with variational free energy, in PyTorch.

The counterpart of ``cortex_tpu/models/gmm.py``: the mean-field
factorization ``q(Z) q(π) Π q(μ_k, τ_k)`` with conjugate updates (Dirichlet
weights, Normal–Gamma per component and dimension, diagonal covariance) —
the classic variational Bayesian GMM — where every update is a batched
message:

- responsibilities = Categorical messages from all data points at once
  (one softmax over ``(..., N, K)``),
- weight/component posteriors = conjugate natural-parameter additions of the
  expected sufficient statistics.

The negative ELBO is the variational free energy, computed in closed form
each iteration and non-increasing, vectorized over replicas.  The JAX
``lax.scan`` over iterations is a Python loop whose free energies are
stacked once; the products run in full float32 (TF32 off).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch.special import digamma, gammaln

from ..ops.chains import _full_float32_matmul
from ..utils.tree import as_operands, as_tensors, as_values

__all__ = ["GMM", "GMMPosterior", "GMMResult"]

_LOG_2PI = math.log(2.0 * math.pi)


class GMMPosterior(NamedTuple):
    """Variational posterior of a diagonal-covariance Bayesian GMM."""

    alpha: torch.Tensor  # (..., K) Dirichlet over weights
    m: torch.Tensor  # (..., K, D) component mean locations
    beta: torch.Tensor  # (..., K, D) mean precision scales
    a: torch.Tensor  # (..., K, D) Gamma shape over precisions
    b: torch.Tensor  # (..., K, D) Gamma rate over precisions

    @property
    def weights(self) -> torch.Tensor:
        (alpha,) = as_values(self.alpha, like=self)
        return alpha / torch.sum(alpha, dim=-1, keepdim=True)

    @property
    def means(self) -> torch.Tensor:
        return self.m

    @property
    def precisions(self) -> torch.Tensor:
        a, b = as_operands(self.a, self.b)
        return a / b


class GMMResult(NamedTuple):
    posterior: GMMPosterior
    responsibilities: torch.Tensor  # (..., N, K)
    free_energy: torch.Tensor  # (..., n_iterations) -ELBO trace, non-increasing


def initial_means(
    x: torch.Tensor, K: int, key: Optional[torch.Generator] = None
) -> torch.Tensor:
    """K distinct data points of every replica, ``(..., K, D)``: the first K
    of a permutation of the N points drawn with ``key`` (a generator seeded
    with 0 on the CPU when ``None``, so the pick does not depend on the
    device of ``x``)."""
    if key is None:
        key = torch.Generator().manual_seed(0)
    idx = torch.randperm(x.shape[-2], generator=key, device=key.device)[:K]
    return x.index_select(-2, idx.to(x.device))


def _trace(values, batch, like: torch.Tensor) -> torch.Tensor:
    """Per-iteration values stacked on a last axis; ``batch + (0,)`` when
    there are none, as JAX's scan gives it for zero iterations."""
    if not values:
        return torch.zeros(tuple(batch) + (0,), dtype=like.dtype, device=like.device)
    return torch.stack(values, dim=-1)


@dataclasses.dataclass(frozen=True)
class GMM:
    """Bayesian GMM with K diagonal-covariance components in D dims.

    Priors: ``π ~ Dir(alpha0)``, ``(μ_kd, τ_kd) ~ NormalGamma(m0, beta0, a0,
    b0)``.
    """

    K: int
    alpha0: float = 1.0
    m0: float = 0.0
    beta0: float = 1.0
    a0: float = 1.0
    b0: float = 1.0

    def fit(
        self,
        x: torch.Tensor,
        n_iterations: int = 50,
        key: Optional[torch.Generator] = None,
        init_means: Optional[torch.Tensor] = None,
    ) -> GMMResult:
        """Run structured VMP on ``x`` of shape ``(..., N, D)``; leading axes
        are independent replicas.  Runs on the device of ``x`` (arrays that
        are not tensors become float32 on the device of the tensors among
        ``x`` and ``init_means``, or on the card).  Without ``init_means`` the
        components start at K distinct data points (:func:`initial_means` with
        ``key``)."""
        x, init_means = as_tensors(x, init_means)
        K = self.K
        N, D = x.shape[-2], x.shape[-1]
        batch = tuple(x.shape[:-2])
        opts = dict(dtype=x.dtype, device=x.device)
        if init_means is None:
            init_means = initial_means(x, K, key)

        post = GMMPosterior(
            alpha=torch.full(batch + (K,), self.alpha0, **opts),
            m=torch.as_tensor(init_means, **opts).expand(batch + (K, D)),
            beta=torch.full(batch + (K, D), self.beta0, **opts),
            a=torch.full(batch + (K, D), self.a0, **opts),
            b=torch.full(batch + (K, D), self.b0, **opts),
        )
        r = torch.zeros(batch + (N, K), **opts)
        fes = []
        with _full_float32_matmul():
            for _ in range(n_iterations):
                post, r, log_r = self._iterate(x, post)
                fes.append(-self._elbo(x, post, r, log_r))
        return GMMResult(post, r, _trace(fes, batch, x))

    def _iterate(self, x, post: GMMPosterior):
        """One VMP iteration: the E-step's responsibilities under ``post``,
        then the M-step's conjugate updates.  Returns ``(post, r, log r)``."""
        D = x.shape[-1]
        # -- E-step: batched Categorical messages (responsibilities) -------
        e_log_pi = digamma(post.alpha) - digamma(torch.sum(post.alpha, dim=-1, keepdim=True))
        e_log_tau = digamma(post.a) - torch.log(post.b)  # (..., K, D)
        e_tau = post.a / post.b
        # E[tau (x - mu)^2] = E[tau](x-m)^2 + 1/beta
        diff2 = (x[..., :, None, :] - post.m[..., None, :, :]) ** 2
        quad = e_tau[..., None, :, :] * diff2 + 1.0 / post.beta[..., None, :, :]  # (..., N, K, D)
        log_rho = (
            e_log_pi[..., None, :]
            + 0.5 * torch.sum(e_log_tau, dim=-1)[..., None, :]
            - 0.5 * D * _LOG_2PI
            - 0.5 * torch.sum(quad, dim=-1)
        )  # (..., N, K)
        log_r = torch.log_softmax(log_rho, dim=-1)
        r = torch.exp(log_r)

        # -- M-step: conjugate updates from expected statistics ------------
        Nk = torch.sum(r, dim=-2) + 1e-10  # (..., K)
        xbar = torch.einsum("...nk,...nd->...kd", r, x) / Nk[..., :, None]  # (..., K, D)
        S = torch.einsum("...nk,...nkd->...kd", r, diff_sq(x, xbar)) / Nk[..., :, None]

        alpha = self.alpha0 + Nk
        nk_kd = Nk[..., :, None].expand(Nk.shape + (D,))
        beta = self.beta0 + nk_kd
        m = (self.beta0 * self.m0 + nk_kd * xbar) / beta
        a = self.a0 + 0.5 * nk_kd
        b = self.b0 + 0.5 * (
            Nk[..., :, None] * S
            + self.beta0 * Nk[..., :, None] * (xbar - self.m0) ** 2 / beta
        )
        return GMMPosterior(alpha, m, beta, a, b), r, log_r

    def _elbo(self, x, post, r, log_r):
        """Closed-form ELBO (Bishop §10.2.2, diagonal specialization)."""
        K = self.K
        D = x.shape[-1]
        alpha, m, beta, a, b = post

        e_log_pi = digamma(alpha) - digamma(torch.sum(alpha, dim=-1, keepdim=True))
        e_log_tau = digamma(a) - torch.log(b)  # (..., K, D)
        e_tau = a / b

        diff2 = (x[..., :, None, :] - m[..., None, :, :]) ** 2
        quad = e_tau[..., None, :, :] * diff2 + 1.0 / beta[..., None, :, :]

        # 1. E[log p(X|Z, mu, tau)]
        t1 = 0.5 * torch.einsum(
            "...nk,...nk->...",
            r,
            torch.sum(e_log_tau, dim=-1)[..., None, :] - D * _LOG_2PI - torch.sum(quad, dim=-1),
        )
        # 2. E[log p(Z|pi)]
        t2 = torch.einsum("...nk,...k->...", r, e_log_pi)
        # 3. E[log p(pi)] with symmetric prior alpha0
        t3 = (
            math.lgamma(K * self.alpha0)
            - K * math.lgamma(self.alpha0)
            + (self.alpha0 - 1.0) * torch.sum(e_log_pi, dim=-1)
        )
        # 4. E[log p(mu, tau)] — NormalGamma(m0, beta0, a0, b0) per (k,d)
        e_tau_mu_m0_sq = e_tau * (m - self.m0) ** 2 + 1.0 / beta
        t4 = torch.sum(
            0.5 * (math.log(self.beta0) - _LOG_2PI + e_log_tau)
            - 0.5 * self.beta0 * e_tau_mu_m0_sq
            + self.a0 * math.log(self.b0)
            - math.lgamma(self.a0)
            + (self.a0 - 1.0) * e_log_tau
            - self.b0 * e_tau,
            dim=(-2, -1),
        )
        # 5. -E[log q(Z)]
        t5 = -torch.einsum("...nk,...nk->...", r, log_r)
        # 6. -E[log q(pi)] = H[Dir(alpha)]
        a0sum = torch.sum(alpha, dim=-1)
        t6 = (
            torch.sum(gammaln(alpha), dim=-1)
            - gammaln(a0sum)
            - torch.sum((alpha - 1.0) * (digamma(alpha) - digamma(a0sum)[..., None]), dim=-1)
        )
        # 7. -E[log q(mu, tau)]: H[Normal] + H[Gamma] per (k,d)
        h_mu = 0.5 * (1.0 + _LOG_2PI - e_log_tau - torch.log(beta))
        h_tau = a - torch.log(b) + gammaln(a) + (1.0 - a) * digamma(a)
        t7 = torch.sum(h_mu + h_tau, dim=(-2, -1))

        return t1 + t2 + t3 + t4 + t5 + t6 + t7


def diff_sq(x: torch.Tensor, xbar: torch.Tensor) -> torch.Tensor:
    """(x_n - xbar_k)^2 with broadcasting: (..., N, K, D)."""
    return (x[..., :, None, :] - xbar[..., None, :, :]) ** 2
