"""Sparse variational GP regression (Titsias SGPR) — the large-n GP path, in PyTorch.

The counterpart of ``cortex_tpu/models/sgp.py``: m ≪ n inducing points, the
collapsed variational bound (Titsias 2009) in O(n m²) — batched products
and m×m triangular factors — a lower bound on the exact log marginal
likelihood that recovers it when the inducing set equals the training
inputs.  Inducing locations are ordinary differentiable parameters, fitted
with the hyperparameters by Adam in :func:`fit_sgpr_ml`.

Formulas follow the standard numerically-stable SGPR parameterization
(one m×m Cholesky of ``B = I + A Aᵀ`` with ``A = L⁻¹ K_mn / σ``).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..dists.gaussian import _cholesky_nan
from ..utils.tree import as_float32_tensor
from .fit import _adam
from .gp import _KERNELS, _points, _solve_lower

__all__ = ["SGPR", "SGPRPosterior", "fit_sgpr_ml"]


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


class SGPRPosterior(NamedTuple):
    """Fitted sparse posterior: ``elbo`` is the collapsed variational lower
    bound on the exact log marginal likelihood; ``predict(Xs)`` returns
    posterior mean and variance at test points."""

    mean_fn: Callable
    elbo: torch.Tensor

    def predict(self, Xs) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.mean_fn(Xs)


@dataclasses.dataclass(frozen=True)
class SGPR:
    """Sparse GP regression with Gaussian noise and m inducing points.

    ``kernel``: name (``"rbf"``/``"matern32"``/``"matern52"``) or a callable
    ``k(a, b, lengthscale, variance)`` (same contract as :class:`GP`).
    """

    kernel: Union[str, Callable] = "rbf"
    lengthscale: float = 1.0
    variance: float = 1.0
    noise: float = 0.1

    def _k(self):
        k = _KERNELS[self.kernel] if isinstance(self.kernel, str) else self.kernel
        return partial(k, lengthscale=self.lengthscale, variance=self.variance)

    def _diag(self, X):
        """The kernel's diagonal at ``X``: the variance for the stationary
        kernels, else computed."""
        if isinstance(self.kernel, str):
            return torch.full((X.shape[0],), 1.0, dtype=X.dtype, device=X.device) * self.variance
        return torch.diagonal(self._k()(X, X))

    def fit(self, X, y, Z, jitter: float = 1e-6) -> SGPRPosterior:
        """Condition on ``(n, d)`` inputs / ``(n,)`` targets with ``(m, d)``
        inducing locations ``Z``.  O(n m²) work, one m×m Cholesky pair."""
        X = _points(X)
        Z = _points(Z, X.device)
        y = as_float32_tensor(y, X.device)
        n, m = X.shape[0], Z.shape[0]
        k = self._k()
        sigma = self.noise**0.5
        eye = torch.eye(m, dtype=X.dtype, device=X.device)

        # Jitter scales with the kernel variance: in f32 the Cholesky of a
        # wide-lengthscale Kmm is rank-deficient at any fixed absolute jitter.
        Kmm = k(Z, Z) + jitter * (1.0 + self.variance) * eye
        L = _cholesky_nan(Kmm)
        A = _solve_lower(L, k(Z, X)) / sigma  # (m, n)
        LB = _cholesky_nan(eye + A @ A.T)
        c = _solve_lower(LB, (A @ y / sigma)[:, None])[:, 0]
        trace_term = torch.sum(self._diag(X)) / self.noise - torch.sum(A * A)
        elbo = (
            -0.5 * n * (math.log(2.0 * math.pi) + _log(self.noise))
            - torch.sum(torch.log(torch.diagonal(LB)))
            - 0.5 * (y @ y) / self.noise
            + 0.5 * (c @ c)
            - 0.5 * trace_term
        )
        return self.posterior(Z, L, LB, c, elbo)

    def posterior(self, Z, L, LB, c, elbo) -> SGPRPosterior:
        """The posterior from its arrays: inducing locations ``(m, d)``, the
        Cholesky factors of ``K_mm`` and of ``B``, ``c = LB⁻¹ A y / σ`` and
        the bound."""
        k = self._k()

        def predict(Xs):
            Xs = _points(Xs, Z.device)
            t1 = _solve_lower(L, k(Z, Xs))
            t2 = _solve_lower(LB, t1)
            mean = t2.T @ c
            var = torch.clamp(
                self._diag(Xs) - torch.sum(t1 * t1, dim=0) + torch.sum(t2 * t2, dim=0), min=1e-12)
            return mean, var

        return SGPRPosterior(predict, elbo)

    def elbo(self, X, y, Z, jitter: float = 1e-6) -> torch.Tensor:
        """Collapsed bound, differentiable w.r.t. hyperparameters *and* Z."""
        return self.fit(X, y, Z, jitter=jitter).elbo


def fit_sgpr_ml(
    X,
    y,
    n_inducing: int = 32,
    kernel: str = "rbf",
    n_steps: int = 300,
    learning_rate: float = 0.05,
    key: Optional[torch.Generator] = None,
) -> Tuple[SGPR, torch.Tensor, torch.Tensor]:
    """Fit hyperparameters *and* inducing locations by Adam on the collapsed
    ELBO.  Inducing points initialize to the first ``n_inducing`` of a
    permutation of the training points drawn with ``key`` (a generator; with
    ``None`` a CPU generator seeded with 0, the same pick on any device).
    Returns ``(fitted SGPR, fitted Z, loss trace)``."""
    X = _points(X)
    y = as_float32_tensor(y, X.device)
    if key is None:
        key = torch.Generator().manual_seed(0)
    idx = torch.randperm(X.shape[0], generator=key, device=key.device)[:n_inducing]
    Z0 = X[idx.to(X.device)]

    def nll(log_hyp, Z):
        model = SGPR(
            kernel=kernel,
            lengthscale=torch.exp(log_hyp[0]),
            variance=torch.exp(log_hyp[1]),
            # Noise floor: the collapsed bound's trace penalty is O(1/σ²) and
            # f32 optimization can otherwise drive σ² → 0 before Z catches up.
            noise=torch.exp(log_hyp[2]) + 1e-4,
        )
        return -model.elbo(X, y, Z, jitter=1e-5)

    v = torch.var(y, correction=0)
    init = torch.stack([torch.zeros_like(v), torch.log(v + 1e-4), torch.log(v / 10 + 1e-4)])
    (log_hyp, Z), losses = _adam(nll, [init, Z0], n_steps, learning_rate)
    model = SGPR(
        kernel=kernel,
        lengthscale=float(torch.exp(log_hyp[0])),
        variance=float(torch.exp(log_hyp[1])),
        noise=float(torch.exp(log_hyp[2])) + 1e-4,
    )
    return model, Z, losses
