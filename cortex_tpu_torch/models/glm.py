"""Generalized linear model family: conjugate linear regression + Poisson EP, in PyTorch.

The counterpart of ``cortex_tpu/models/glm.py``:

- :class:`BayesianLinearRegression` — the exact Normal–Inverse-Gamma
  posterior over (weights, noise variance) for arbitrary design matrices:
  one batched d×d inverse, closed-form log evidence (multivariate-t
  marginal) and Student-t posterior predictives.
  :class:`~cortex_tpu_torch.models.BayesianAR` is this model on a lag
  design; the NIG algebra lives here and is shared.
- :class:`PoissonRegression` — counts with a log link, fit by parallel EP
  with Gauss–Hermite moment matching (``ops.ep``); the predictive rate
  integrates the log-normal rate over the weight posterior.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from ..dists.gaussian import _device
from ..ops.ep import EPResult, ep_linear_model, gauss_hermite_tilted
from ..utils.tree import as_float32_tensor

__all__ = [
    "BayesianLinearRegression",
    "NIGPosterior",
    "PoissonRegression",
    "PoissonPosterior",
    "nig_fit",
]


class NIGPosterior(NamedTuple):
    """Exact Normal–Inverse-Gamma posterior: ``w | σ² ~ N(mean, σ² cov_scale)``,
    ``σ² ~ InvGamma(a, b)``; ``log_evidence`` is the marginal likelihood of
    the targets (multivariate-t)."""

    mean: torch.Tensor  # (..., d)
    cov_scale: torch.Tensor  # (..., d, d) — V_n (multiply by σ² for the cov)
    a: torch.Tensor  # (...,)
    b: torch.Tensor  # (...,)
    log_evidence: torch.Tensor  # (...,)

    @property
    def noise_mean(self) -> torch.Tensor:
        """Posterior mean of σ² (requires a > 1)."""
        return self.b / (self.a - 1.0)

    @property
    def coeff_cov(self) -> torch.Tensor:
        """Marginal coefficient covariance E[σ²]·V_n (a > 1)."""
        return self.noise_mean[..., None, None] * self.cov_scale


def nig_fit(X, t, prior_scale: float = 100.0, a0: float = 2.0, b0: float = 1.0) -> NIGPosterior:
    """Exact NIG update for ``t = X w + N(0, σ²)`` with prior
    ``w|σ² ~ N(0, σ² prior_scale·I)``, ``σ² ~ InvGamma(a0, b0)``.

    ``X``: ``(..., n, d)``; ``t``: ``(..., n)``.  Batched over leading axes
    (one inverse per replica problem).
    """
    dev = _device(X, t)
    X, t = as_float32_tensor(X, dev), as_float32_tensor(t, dev)
    d = X.shape[-1]
    n = t.shape[-1]
    Xt = X.mT
    prec = torch.eye(d, dtype=X.dtype, device=dev) / prior_scale + Xt @ X
    Vn = torch.linalg.inv(prec)
    mn = (Vn @ (Xt @ t[..., None]))[..., 0]
    a_n = a0 + 0.5 * n
    quad = torch.sum(t * t, dim=-1) - torch.sum(mn * (prec @ mn[..., None])[..., 0], dim=-1)
    b_n = b0 + 0.5 * quad
    _, logdet_prec = torch.linalg.slogdet(prec)
    logdet_V0_inv = -d * math.log(prior_scale)
    lgamma = torch.lgamma(torch.tensor([a_n, a0], dtype=X.dtype, device=dev))
    log_ev = (
        -0.5 * n * math.log(2.0 * math.pi)
        + 0.5 * (logdet_V0_inv - logdet_prec)
        + a0 * math.log(b0)
        - a_n * torch.log(b_n)
        + lgamma[0]
        - lgamma[1]
    )
    return NIGPosterior(mn, Vn, torch.full_like(b_n, a_n), b_n, log_ev)


@dataclasses.dataclass(frozen=True)
class BayesianLinearRegression:
    """``y = X w + N(0, σ²)`` with the conjugate NIG prior."""

    prior_scale: float = 100.0
    a0: float = 2.0
    b0: float = 1.0

    def fit(self, X, y) -> NIGPosterior:
        """Exact posterior from a ``(..., n, d)`` design and ``(..., n)``
        targets."""
        return nig_fit(X, y, self.prior_scale, self.a0, self.b0)

    def predictive(
        self, posterior: NIGPosterior, Xs
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Student-t posterior predictive at ``(m, d)`` test points:
        ``(mean, scale², dof)`` with dof = 2a, so that moments stay exact
        (the variance is ``scale² · dof/(dof-2)``)."""
        Xs = torch.atleast_2d(as_float32_tensor(Xs, posterior.mean.device))
        mean = Xs @ posterior.mean
        scale2 = (posterior.b / posterior.a) * (
            1.0 + torch.sum((Xs @ posterior.cov_scale) * Xs, dim=-1)
        )
        return mean, scale2, 2.0 * posterior.a


def _latent(mean, cov, Xs):
    """Mean and variance of ``x·w`` at ``(m, d)`` inputs under ``N(mean, cov)``."""
    Xs = torch.atleast_2d(as_float32_tensor(Xs, mean.device))
    return Xs @ mean, torch.sum((Xs @ cov) * Xs, dim=-1)


class PoissonPosterior(NamedTuple):
    """Gaussian EP posterior over the log-rate weights."""

    mean: torch.Tensor
    cov: torch.Tensor
    ep: EPResult

    def predict_rate(self, Xs) -> torch.Tensor:
        """Posterior-predictive mean rate E[exp(x·w)] (log-normal mean)."""
        mu, var = _latent(self.mean, self.cov, Xs)
        return torch.exp(mu + 0.5 * var)


@dataclasses.dataclass(frozen=True)
class PoissonRegression:
    """Poisson GLM ``y_i ~ Poisson(exp(x_i·w))`` with a Gaussian weight
    prior, fit by parallel EP with Gauss–Hermite sites."""

    prior_var: float = 1.0
    n_iters: int = 60
    damping: float = 0.6
    n_quad: int = 31

    def fit(self, X, y) -> PoissonPosterior:
        """``X``: ``(n, d)``; ``y``: ``(n,)`` non-negative counts."""
        dev = _device(X, y)
        X = torch.atleast_2d(as_float32_tensor(X, dev))
        y = as_float32_tensor(y, dev).to(X.dtype)

        def log_lik(z):  # z: (n, k); Poisson log-pmf up to the y! constant
            zc = torch.clamp(z, -30.0, 30.0)
            return y[:, None] * zc - torch.exp(zc)

        tilted = gauss_hermite_tilted(log_lik, n_points=self.n_quad)
        ep = ep_linear_model(X, tilted, prior_var=self.prior_var, n_iters=self.n_iters,
                             damping=self.damping)
        return PoissonPosterior(ep.mean, ep.cov, ep)
