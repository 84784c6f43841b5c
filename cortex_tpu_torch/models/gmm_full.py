"""Full-covariance variational Bayesian GMM (Normal–Wishart components), in PyTorch.

The counterpart of ``cortex_tpu/models/gmm_full.py``: the complete Bishop
§10.2 treatment, ``q(Z) q(π) Π q(μ_k, Λ_k)`` with ``π ~ Dir(α0)`` and
``(μ_k, Λ_k) ~ N(m0, (β0 Λ_k)^-1) W(W0, ν0)`` — full precision matrices, so
correlated clusters are modeled exactly (the diagonal
:class:`cortex_tpu_torch.models.gmm.GMM` cannot).  Batched over replicas; the
variational free energy (−ELBO, eqs. 10.70–10.77) is tracked in closed form
and does not increase.  Small SPD inverses and log-determinants are the
port's pivotless eliminations (:mod:`cortex_tpu_torch.dists.gaussian`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch.special import digamma, gammaln, multigammaln

from ..dists.gaussian import _spd_inv, _spd_logdet
from ..ops.chains import _full_float32_matmul
from ..utils.tree import as_operands, as_tensors, as_values
from .gmm import _trace, initial_means

__all__ = ["GMMFull", "GMMFullPosterior", "GMMFullResult"]

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


def _e_logdet_lambda(nu, W):
    """E[log|Λ|] = Σ_d ψ((ν+1−d)/2) + D log2 + log|W|."""
    D = W.shape[-1]
    i = torch.arange(1, D + 1, dtype=W.dtype, device=W.device)
    return (
        torch.sum(digamma((nu[..., None] + 1.0 - i) / 2.0), dim=-1)
        + D * _LOG_2
        + _spd_logdet(W)
    )


def _log_B(W, nu):
    """log of the Wishart normalizer B(W, ν) (Bishop B.79)."""
    D = W.shape[-1]
    return -0.5 * nu * _spd_logdet(W) - 0.5 * nu * D * _LOG_2 - multigammaln(nu / 2.0, D)


class GMMFullPosterior(NamedTuple):
    alpha: torch.Tensor  # (..., K)
    m: torch.Tensor  # (..., K, D)
    beta: torch.Tensor  # (..., K)
    W: torch.Tensor  # (..., K, D, D) Wishart scale
    nu: torch.Tensor  # (..., K) Wishart dof

    @property
    def weights(self) -> torch.Tensor:
        (alpha,) = as_values(self.alpha, like=self)
        return alpha / torch.sum(alpha, dim=-1, keepdim=True)

    @property
    def means(self) -> torch.Tensor:
        return self.m

    @property
    def expected_precisions(self) -> torch.Tensor:
        nu, W = as_operands(self.nu, self.W)
        return nu[..., None, None] * W

    @property
    def expected_covariances(self) -> torch.Tensor:
        """E[Σ_k] under the Wishart posterior: ``W_k^-1 / (ν_k − D − 1)``
        (defined for ν > D + 1; the divisor is clamped positive, so values for
        barely-populated components are upper bounds)."""
        W, nu = as_values(self.W, self.nu, like=self)
        divisor = torch.clamp(nu - W.shape[-1] - 1.0, min=1e-6)
        return _spd_inv(W) / divisor[..., None, None]


class GMMFullResult(NamedTuple):
    posterior: GMMFullPosterior
    responsibilities: torch.Tensor  # (..., N, K)
    free_energy: torch.Tensor  # (..., n_iterations)


@dataclasses.dataclass(frozen=True)
class GMMFull:
    """Bayesian GMM with K full-covariance components in D dims."""

    K: int
    alpha0: float = 1.0
    beta0: float = 1.0
    nu0: Optional[float] = None  # default: D
    m0: float = 0.0
    w0_scale: float = 1.0  # W0 = w0_scale * I

    def fit(
        self,
        x: torch.Tensor,
        n_iterations: int = 50,
        key: Optional[torch.Generator] = None,
        init_means: Optional[torch.Tensor] = None,
    ) -> GMMFullResult:
        """Run structured VMP on ``x`` of shape ``(..., N, D)`` on its
        device; inputs and initialization as
        :meth:`cortex_tpu_torch.models.GMM.fit`."""
        x, init_means = as_tensors(x, init_means)
        K = self.K
        N, D = x.shape[-2], x.shape[-1]
        batch = tuple(x.shape[:-2])
        opts = dict(dtype=x.dtype, device=x.device)
        nu0 = float(self.nu0) if self.nu0 is not None else float(D)
        W0 = self.w0_scale * torch.eye(D, **opts)
        prior = (nu0, W0, _spd_inv(W0), torch.full((D,), self.m0, **opts))
        if init_means is None:
            init_means = initial_means(x, K, key)

        post = GMMFullPosterior(
            alpha=torch.full(batch + (K,), self.alpha0, **opts),
            m=torch.as_tensor(init_means, **opts).expand(batch + (K, D)),
            beta=torch.full(batch + (K,), self.beta0, **opts),
            W=W0.expand(batch + (K, D, D)),
            nu=torch.full(batch + (K,), nu0, **opts),
        )
        r = torch.zeros(batch + (N, K), **opts)
        fes = []
        with _full_float32_matmul():
            for _ in range(n_iterations):
                post, r, fe = self._iterate(x, post, prior)
                fes.append(fe)
        return GMMFullResult(post, r, _trace(fes, batch, x))

    def _iterate(self, x, post: GMMFullPosterior, prior):
        """One VMP iteration (E-step under ``post``, then the M-step);
        returns ``(post, r, free energy)``."""
        nu0, W0, W0_inv, m0 = prior
        D = x.shape[-1]
        alpha, m, beta, W, nu = post

        # -- E-step --------------------------------------------------------
        e_log_pi = digamma(alpha) - digamma(torch.sum(alpha, dim=-1, keepdim=True))
        e_logdet = _e_logdet_lambda(nu, W)  # (..., K)
        diff = x[..., :, None, :] - m[..., None, :, :]  # (..., N, K, D)
        quad = nu[..., None, :] * torch.einsum(
            "...nkd,...kde,...nke->...nk", diff, W, diff
        ) + D / beta[..., None, :]
        log_rho = (
            e_log_pi[..., None, :]
            + 0.5 * e_logdet[..., None, :]
            - 0.5 * D * _LOG_2PI
            - 0.5 * quad
        )
        log_r = torch.log_softmax(log_rho, dim=-1)
        r = torch.exp(log_r)

        # -- M-step --------------------------------------------------------
        Nk = torch.sum(r, dim=-2) + 1e-10  # (..., K)
        xbar = torch.einsum("...nk,...nd->...kd", r, x) / Nk[..., :, None]
        dxb = x[..., :, None, :] - xbar[..., None, :, :]
        S = torch.einsum("...nk,...nkd,...nke->...kde", r, dxb, dxb) / Nk[..., :, None, None]
        alpha_n = self.alpha0 + Nk
        beta_n = self.beta0 + Nk
        m_n = (self.beta0 * m0 + Nk[..., :, None] * xbar) / beta_n[..., :, None]
        nu_n = nu0 + Nk
        dm = xbar - m0
        W_inv = (
            W0_inv
            + Nk[..., :, None, None] * S
            + (self.beta0 * Nk / beta_n)[..., :, None, None] * dm[..., :, None] * dm[..., None, :]
        )
        new_post = GMMFullPosterior(alpha_n, m_n, beta_n, _spd_inv(W_inv), nu_n)
        fe = -self._elbo(x, new_post, r, log_r, Nk, xbar, S, prior)
        return new_post, r, fe

    def _elbo(self, x, post, r, log_r, Nk, xbar, S, prior):
        """Bishop eqs. 10.70–10.77 (full covariance)."""
        nu0, W0, W0_inv, m0 = prior
        K = self.K
        D = x.shape[-1]
        alpha, m, beta, W, nu = post

        e_log_pi = digamma(alpha) - digamma(torch.sum(alpha, dim=-1, keepdim=True))
        e_logdet = _e_logdet_lambda(nu, W)

        # 10.71
        dxm = xbar - m
        t1 = 0.5 * torch.sum(
            Nk
            * (
                e_logdet
                - D / beta
                - nu * torch.einsum("...kde,...ked->...k", S, W)
                - nu * torch.einsum("...kd,...kde,...ke->...k", dxm, W, dxm)
                - D * _LOG_2PI
            ),
            dim=-1,
        )
        # 10.72
        t2 = torch.einsum("...nk,...k->...", r, e_log_pi)
        # 10.73
        t3 = (
            math.lgamma(K * self.alpha0)
            - K * math.lgamma(self.alpha0)
            + (self.alpha0 - 1.0) * torch.sum(e_log_pi, dim=-1)
        )
        # 10.74
        dm0 = m - m0
        t4 = (
            0.5
            * torch.sum(
                D * math.log(self.beta0 / (2.0 * math.pi))
                + e_logdet
                - D * self.beta0 / beta
                - self.beta0 * nu * torch.einsum("...kd,...kde,...ke->...k", dm0, W, dm0),
                dim=-1,
            )
            + K * _log_B(W0, torch.tensor(nu0, dtype=W0.dtype, device=W0.device))
            + 0.5 * (nu0 - D - 1.0) * torch.sum(e_logdet, dim=-1)
            - 0.5 * torch.sum(nu * torch.einsum("de,...ked->...k", W0_inv, W), dim=-1)
        )
        # 10.75
        t5 = torch.einsum("...nk,...nk->...", r, log_r)
        # 10.76
        a0sum = torch.sum(alpha, dim=-1)
        t6 = (
            torch.sum((alpha - 1.0) * e_log_pi, dim=-1)
            + gammaln(a0sum)
            - torch.sum(gammaln(alpha), dim=-1)
        )
        # 10.77 with H[W] = -log B - ((ν-D-1)/2) E[log|Λ|] + νD/2
        h_w = -_log_B(W, nu) - 0.5 * (nu - D - 1.0) * e_logdet + 0.5 * nu * D
        t7 = torch.sum(
            0.5 * e_logdet + 0.5 * D * torch.log(beta / (2.0 * math.pi)) - 0.5 * D - h_w,
            dim=-1,
        )
        return t1 + t2 + t3 + t4 - t5 - t6 - t7
