"""Gaussian message algebra in natural (information) form, batched over leading axes.

The counterpart of ``cortex_tpu/dists/gaussian.py``.  A Gaussian message is
``(xi, w)`` with ``xi = w * mean`` (precision-weighted mean) and ``w`` the
precision, stored as tensors with arbitrary leading batch dimensions.
Products of messages are then plain additions, and moments are recovered at
the end.

Dtype follows the inputs.  Python and numpy values become float32 tensors,
as ``jnp.asarray`` makes them with 64-bit types off; constructors given no
tensor put them on the card unless the caller names another ``device``;
the methods take Python and numpy fields and arguments as
``dists.conjugate``'s do.  ``sample`` takes a ``torch.Generator`` on the
values' device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..utils.tree import as_operands, as_values

__all__ = [
    "Gaussian",
    "MvGaussian",
    "from_mean_variance",
    "from_mean_precision",
    "mv_from_mean_precision",
    "mv_from_mean_cov",
]

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Gaussian:
    """Univariate Gaussian in information form: ``xi = w·μ``, ``w = 1/σ²``.

    Leading dimensions of ``xi``/``w`` are batch dimensions.
    """

    xi: torch.Tensor
    w: torch.Tensor

    # -- moments -------------------------------------------------------------
    @property
    def mean(self) -> torch.Tensor:
        xi, w = as_operands(self.xi, self.w)
        return xi / w

    @property
    def variance(self) -> torch.Tensor:
        return 1.0 / self.w

    @property
    def precision(self) -> torch.Tensor:
        return self.w

    # -- algebra -------------------------------------------------------------
    def __mul__(self, other: "Gaussian") -> "Gaussian":
        """Product of densities (unnormalized): add natural parameters."""
        xi1, xi2 = as_operands(self.xi, other.xi)
        w1, w2 = as_operands(self.w, other.w)
        return Gaussian(xi1 + xi2, w1 + w2)

    @classmethod
    def reduce_product(cls, stacked: "Gaussian", axis: int = 0) -> "Gaussian":
        """Product of k stacked Gaussians in ONE reduction — natural
        parameters are additive, so the fold is a plain sum."""
        xi, w = as_values(stacked.xi, stacked.w)
        return cls(torch.sum(xi, axis), torch.sum(w, axis))

    def __truediv__(self, other: "Gaussian") -> "Gaussian":
        """Density quotient: subtract natural parameters (cavity products)."""
        xi1, xi2 = as_operands(self.xi, other.xi)
        w1, w2 = as_operands(self.w, other.w)
        return Gaussian(xi1 - xi2, w1 - w2)

    def log_normalizer(self) -> torch.Tensor:
        """log ∫ exp(xi·x − w·x²/2) dx = xi²/(2w) + ½·log(2π/w)."""
        xi, w = as_values(self.xi, self.w)
        return 0.5 * (xi**2 / w + torch.log(2.0 * math.pi / w))

    def logpdf(self, x) -> torch.Tensor:
        xi, w, x = as_values(self.xi, self.w, x)
        return -0.5 * (w * (x - xi / w) ** 2 + _LOG_2PI - torch.log(w))

    def entropy(self) -> torch.Tensor:
        (w,) = as_values(self.w, like=self)
        return 0.5 * (1.0 + _LOG_2PI - torch.log(w))

    def kl(self, other: "Gaussian") -> torch.Tensor:
        """KL(self ‖ other)."""
        xi, w, xio, wo = as_values(self.xi, self.w, other.xi, other.w)
        m, v = xi / w, 1.0 / w
        mo, vo = xio / wo, 1.0 / wo
        return 0.5 * (torch.log(vo / v) + (v + (m - mo) ** 2) / vo - 1.0)

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        xi, w = as_values(self.xi, self.w)
        eps = torch.randn(tuple(shape) + tuple(xi.shape), generator=key, dtype=xi.dtype,
                          device=xi.device)
        return xi / w + eps * torch.sqrt(1.0 / w)


def from_mean_variance(mean, variance, device=None) -> Gaussian:
    """Construct from (μ, σ²) — the reference's ``NormalMeanVariance``."""
    mean, variance = as_values(mean, variance, device=device)
    w = 1.0 / variance
    return Gaussian(mean * w, w)


def from_mean_precision(mean, precision, device=None) -> Gaussian:
    """Construct from (μ, w) — the reference's ``NormalMeanPrecision``."""
    mean, precision = as_values(mean, precision, device=device)
    return Gaussian(mean * precision, precision)


def _spd_solve_logdet(M, B):
    """Batched ``solve(M, B)`` + ``log det M`` for small SPD ``M`` by
    pivotless Gauss-Jordan, as the JAX package computes it.  Pivotless
    elimination is valid here: an SPD matrix has strictly positive leading
    principal minors, so every pivot is nonzero.  Above d = 32 it calls
    ``torch.linalg.solve`` and ``slogdet``."""
    d = M.shape[-1]
    if d > 32:
        sol = torch.linalg.solve(M, B)
        _, logdet = torch.linalg.slogdet(M)
        return sol, logdet
    aug = torch.cat([M, B], dim=-1)
    idx = torch.arange(d, device=M.device)
    logdet = torch.zeros(M.shape[:-2], dtype=M.dtype, device=M.device)
    for i in range(d):
        piv = aug[..., i, i]
        logdet = logdet + torch.log(torch.abs(piv))
        piv_row = aug[..., i : i + 1, :] / piv[..., None, None]
        factors = aug[..., :, i : i + 1]
        is_i = (idx == i)[:, None]
        aug = torch.where(is_i, piv_row, aug - factors * piv_row)
    return aug[..., :, d:], logdet


def _spd_inv(M):
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)
    return _spd_solve_logdet(M, eye)[0]


def _spd_logdet(M):
    return _spd_solve_logdet(M, M[..., :, :1])[1]


def _cholesky_nan(M):
    """``torch.linalg.cholesky`` with NaN where the matrix is not positive
    definite, as ``jnp.linalg.cholesky`` gives (torch raises)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, math.nan))


def _spd_cholesky(M):
    """Lower Cholesky of small SPD matrices as an unrolled batched
    elimination, as the JAX package computes it; above d = 32,
    :func:`_cholesky_nan`."""
    d = M.shape[-1]
    if d > 32:
        return _cholesky_nan(M)
    L = torch.zeros_like(M)
    for j in range(d):
        r = M[..., j:, j] - torch.einsum("...ik,...k->...i", L[..., j:, :j], L[..., j, :j])
        diag = torch.sqrt(r[..., 0])
        L = L.clone()
        L[..., j:, j] = r / diag[..., None]
    return L


@dataclasses.dataclass(frozen=True)
class MvGaussian:
    """Multivariate Gaussian in information form: ``xi = W·μ``, ``W`` the
    precision matrix.  ``xi``: ``(..., d)``, ``W``: ``(..., d, d)``."""

    xi: torch.Tensor
    W: torch.Tensor

    @property
    def dim(self) -> int:
        return self.xi.shape[-1]

    @property
    def mean(self) -> torch.Tensor:
        xi, W = as_values(self.xi, self.W)
        return _spd_solve_logdet(W, xi[..., None])[0][..., 0]

    @property
    def cov(self) -> torch.Tensor:
        return _spd_inv(*as_values(self.W, like=self))

    @property
    def precision(self) -> torch.Tensor:
        return self.W

    def __mul__(self, other: "MvGaussian") -> "MvGaussian":
        xi1, xi2 = as_operands(self.xi, other.xi)
        W1, W2 = as_operands(self.W, other.W)
        return MvGaussian(xi1 + xi2, W1 + W2)

    @classmethod
    def reduce_product(cls, stacked: "MvGaussian", axis: int = 0) -> "MvGaussian":
        """Product of k stacked MvGaussians in ONE reduction (natural
        parameters additive)."""
        xi, W = as_values(stacked.xi, stacked.W)
        return cls(torch.sum(xi, axis), torch.sum(W, axis))

    def __truediv__(self, other: "MvGaussian") -> "MvGaussian":
        xi1, xi2 = as_operands(self.xi, other.xi)
        W1, W2 = as_operands(self.W, other.W)
        return MvGaussian(xi1 - xi2, W1 - W2)

    def log_normalizer(self) -> torch.Tensor:
        xi, W = as_values(self.xi, self.W)
        sol, logdet = _spd_solve_logdet(W, xi[..., None])
        return 0.5 * (
            torch.einsum("...i,...i->...", xi, sol[..., 0]) + self.dim * _LOG_2PI - logdet
        )

    def entropy(self) -> torch.Tensor:
        d = self.dim
        (W,) = as_values(self.W, like=self)
        eye = torch.eye(d, dtype=W.dtype, device=W.device).expand(W.shape)
        _, logdet = _spd_solve_logdet(W, eye[..., :1])
        return 0.5 * (d * (1.0 + _LOG_2PI) - logdet)

    def logpdf(self, x) -> torch.Tensor:
        xi, W, x = as_values(self.xi, self.W, x)
        sol, logdet = _spd_solve_logdet(W, xi[..., None])
        diff = x - sol[..., 0]
        quad = torch.einsum("...i,...ij,...j->...", diff, W, diff)
        return -0.5 * (quad + self.dim * _LOG_2PI - logdet)

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        g = MvGaussian(*as_values(self.xi, self.W))
        chol = _cholesky_nan(g.cov)
        eps = torch.randn(tuple(shape) + tuple(g.xi.shape), generator=key, dtype=g.xi.dtype,
                          device=g.xi.device)
        return g.mean + torch.einsum("...ij,...j->...i", chol, eps)


def mv_from_mean_precision(mean, precision, device=None) -> MvGaussian:
    """Construct from (mean ``(..., d)``, precision ``(..., d, d)``)."""
    mean, precision = as_values(mean, precision, device=device)
    xi = torch.einsum("...ij,...j->...i", precision, mean)
    return MvGaussian(xi, precision)


def mv_from_mean_cov(mean, cov, device=None) -> MvGaussian:
    """Construct from (mean ``(..., d)``, covariance ``(..., d, d)``)."""
    mean, cov = as_values(mean, cov, device=device)
    return mv_from_mean_precision(mean, _spd_inv(cov))
