"""Exact Gaussian-process regression, in PyTorch.

The counterpart of ``cortex_tpu/models/gp.py``: kernels are plain functions
on ``(n, d)`` points; the posterior is one Cholesky of the n×n kernel
matrix (jitter-stabilized float32, never an inverse); predictions batch
over any number of test points; the log marginal likelihood is
differentiable in the hyperparameters, which :func:`fit_gp_ml` fits by
Adam (``torch.optim.Adam`` with optax's defaults, a Python loop over
steps).  Where the kernel matrix is not positive definite the Cholesky
gives NaN, as JAX's does (torch's would raise).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, NamedTuple, Tuple, Union

import torch

from ..dists.gaussian import _cholesky_nan, _device
from ..utils.tree import as_float32_tensor
from .fit import _adam

__all__ = [
    "GP",
    "GPPosterior",
    "fit_gp_ml",
    "rbf_kernel",
    "matern32_kernel",
    "matern52_kernel",
]


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances between ``(n, d)`` and ``(m, d)``."""
    return torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)


def rbf_kernel(a, b, lengthscale=1.0, variance=1.0):
    """Squared-exponential kernel k(x,x') = σ² exp(−|x−x'|²/2ℓ²)."""
    return variance * torch.exp(-0.5 * _sqdist(a, b) / lengthscale**2)


def matern32_kernel(a, b, lengthscale=1.0, variance=1.0):
    """Matérn-3/2: σ² (1+√3r/ℓ) exp(−√3r/ℓ) — once-differentiable paths."""
    r = torch.sqrt(_sqdist(a, b) + 1e-12)
    z = math.sqrt(3.0) * r / lengthscale
    return variance * (1.0 + z) * torch.exp(-z)


def matern52_kernel(a, b, lengthscale=1.0, variance=1.0):
    """Matérn-5/2: σ² (1+√5r/ℓ+5r²/3ℓ²) exp(−√5r/ℓ)."""
    r = torch.sqrt(_sqdist(a, b) + 1e-12)
    z = math.sqrt(5.0) * r / lengthscale
    return variance * (1.0 + z + z**2 / 3.0) * torch.exp(-z)


_KERNELS = {"rbf": rbf_kernel, "matern32": matern32_kernel, "matern52": matern52_kernel}


def _points(X, device=None) -> torch.Tensor:
    return torch.atleast_2d(as_float32_tensor(X, _device(X, device=device)))


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


class GPPosterior(NamedTuple):
    """Fitted posterior: call ``predict(Xs)`` for test beliefs; ``lml`` is
    the log marginal likelihood of the training data."""

    mean_fn: Callable
    lml: torch.Tensor

    def predict(self, Xs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and variance at ``(m, d)`` test points."""
        return self.mean_fn(Xs)


@dataclasses.dataclass(frozen=True)
class GP:
    """Zero-mean GP prior ``f ~ GP(0, k)`` with Gaussian observation noise.

    ``kernel``: name (``"rbf"``/``"matern32"``/``"matern52"``) or a callable
    ``k(a, b, lengthscale, variance)``.  Hyperparameters may be tensors (to
    differentiate through them).
    """

    kernel: Union[str, Callable] = "rbf"
    lengthscale: float = 1.0
    variance: float = 1.0
    noise: float = 0.1

    def _k(self):
        k = _KERNELS[self.kernel] if isinstance(self.kernel, str) else self.kernel
        return partial(k, lengthscale=self.lengthscale, variance=self.variance)

    def fit(self, X, y, jitter: float = 1e-6) -> GPPosterior:
        """Condition on ``(n, d)`` inputs and ``(n,)`` targets: one Cholesky
        of the n×n kernel matrix; prediction is two triangular solves."""
        X = _points(X)
        y = as_float32_tensor(y, X.device)
        n = X.shape[0]
        K = self._k()(X, X) + (self.noise + jitter) * torch.eye(n, dtype=X.dtype, device=X.device)
        L = _cholesky_nan(K)
        alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
        lml = (
            -0.5 * y @ alpha
            - torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * n * math.log(2.0 * math.pi)
        )
        return self.posterior(X, alpha, L, lml)

    def posterior(self, X, alpha, L, lml) -> GPPosterior:
        """The posterior from its arrays: training inputs ``(n, d)``, weights
        ``alpha = K⁻¹y`` ``(n,)``, the Cholesky factor ``L`` of the noisy
        kernel matrix and the log marginal likelihood."""
        k = self._k()

        def predict(Xs):
            Xs = _points(Xs, X.device)
            Ks = k(X, Xs)  # (n, m)
            mean = Ks.T @ alpha
            v = _solve_lower(L, Ks)  # (n, m)
            var = torch.clamp(torch.diagonal(k(Xs, Xs)) - torch.sum(v * v, dim=0), min=1e-12)
            return mean, var

        return GPPosterior(predict, lml)

    def log_marginal_likelihood(self, X, y, jitter: float = 1e-6) -> torch.Tensor:
        """Differentiable w.r.t. the hyperparameters (pass them as tensors
        for gradient-based fitting)."""
        return self.fit(X, y, jitter=jitter).lml


def fit_gp_ml(
    X,
    y,
    kernel: str = "rbf",
    n_steps: int = 200,
    learning_rate: float = 0.05,
) -> Tuple[GP, torch.Tensor]:
    """ML-II hyperparameters (lengthscale, variance, noise) by Adam on the
    exact log marginal likelihood; returns the fitted :class:`GP` and the
    loss trace (the loss before each step)."""
    X = _points(X)
    y = as_float32_tensor(y, X.device)

    def nll(params):
        gp = GP(kernel=kernel, lengthscale=torch.exp(params[0]),
                variance=torch.exp(params[1]), noise=torch.exp(params[2]))
        return -gp.log_marginal_likelihood(X, y)

    v = torch.var(y, correction=0)
    init = torch.stack([torch.zeros_like(v), torch.log(v + 1e-4), torch.log(v / 10 + 1e-4)])
    (p,), losses = _adam(nll, [init], n_steps, learning_rate)
    lengthscale, variance, noise = (float(a) for a in torch.exp(p))
    return GP(kernel=kernel, lengthscale=lengthscale, variance=variance, noise=noise), losses
