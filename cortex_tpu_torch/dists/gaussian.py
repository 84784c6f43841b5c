"""Gaussian message algebra in natural (information) form, batched over leading axes.

The counterpart of ``cortex_tpu/dists/gaussian.py``.  A Gaussian message is
``(xi, w)`` with ``xi = w * mean`` (precision-weighted mean) and ``w`` the
precision, stored as tensors with arbitrary leading batch dimensions.
Products of messages are then plain additions, and moments are recovered at
the end.

Dtype follows the inputs.  Python and numpy values become float32 tensors,
as ``jnp.asarray`` makes them with 64-bit types off; constructors given no
tensor put them on the card unless the caller names another ``device``.
``sample`` takes a ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..utils.tree import as_float32_tensor, input_device

__all__ = [
    "Gaussian",
    "MvGaussian",
    "from_mean_variance",
    "from_mean_precision",
    "mv_from_mean_precision",
    "mv_from_mean_cov",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _tensors(*xs, device=None):
    dev = input_device(*xs, device=device)
    return tuple(as_float32_tensor(x, dev) for x in xs)


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
        return self.xi / self.w

    @property
    def variance(self) -> torch.Tensor:
        return 1.0 / self.w

    @property
    def precision(self) -> torch.Tensor:
        return self.w

    # -- algebra -------------------------------------------------------------
    def __mul__(self, other: "Gaussian") -> "Gaussian":
        """Product of densities (unnormalized): add natural parameters."""
        return Gaussian(self.xi + other.xi, self.w + other.w)

    @classmethod
    def reduce_product(cls, stacked: "Gaussian", axis: int = 0) -> "Gaussian":
        """Product of k stacked Gaussians in ONE reduction — natural
        parameters are additive, so the fold is a plain sum."""
        return cls(torch.sum(stacked.xi, axis), torch.sum(stacked.w, axis))

    def __truediv__(self, other: "Gaussian") -> "Gaussian":
        """Density quotient: subtract natural parameters (cavity products)."""
        return Gaussian(self.xi - other.xi, self.w - other.w)

    def log_normalizer(self) -> torch.Tensor:
        """log ∫ exp(xi·x − w·x²/2) dx = xi²/(2w) + ½·log(2π/w)."""
        return 0.5 * (self.xi**2 / self.w + torch.log(2.0 * math.pi / self.w))

    def logpdf(self, x) -> torch.Tensor:
        return -0.5 * (self.w * (x - self.mean) ** 2 + _LOG_2PI - torch.log(self.w))

    def entropy(self) -> torch.Tensor:
        return 0.5 * (1.0 + _LOG_2PI - torch.log(self.w))

    def kl(self, other: "Gaussian") -> torch.Tensor:
        """KL(self ‖ other)."""
        m, v = self.mean, self.variance
        mo, vo = other.mean, other.variance
        return 0.5 * (torch.log(vo / v) + (v + (m - mo) ** 2) / vo - 1.0)

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        eps = torch.randn(
            tuple(shape) + tuple(self.xi.shape), generator=key,
            dtype=self.xi.dtype, device=self.xi.device,
        )
        return self.mean + eps * torch.sqrt(self.variance)


def from_mean_variance(mean, variance, device=None) -> Gaussian:
    """Construct from (μ, σ²) — the reference's ``NormalMeanVariance``."""
    mean, variance = _tensors(mean, variance, device=device)
    w = 1.0 / variance
    return Gaussian(mean * w, w)


def from_mean_precision(mean, precision, device=None) -> Gaussian:
    """Construct from (μ, w) — the reference's ``NormalMeanPrecision``."""
    mean, precision = _tensors(mean, precision, device=device)
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
        return _spd_solve_logdet(self.W, self.xi[..., None])[0][..., 0]

    @property
    def cov(self) -> torch.Tensor:
        return _spd_inv(self.W)

    @property
    def precision(self) -> torch.Tensor:
        return self.W

    def __mul__(self, other: "MvGaussian") -> "MvGaussian":
        return MvGaussian(self.xi + other.xi, self.W + other.W)

    @classmethod
    def reduce_product(cls, stacked: "MvGaussian", axis: int = 0) -> "MvGaussian":
        """Product of k stacked MvGaussians in ONE reduction (natural
        parameters additive)."""
        return cls(torch.sum(stacked.xi, axis), torch.sum(stacked.W, axis))

    def __truediv__(self, other: "MvGaussian") -> "MvGaussian":
        return MvGaussian(self.xi - other.xi, self.W - other.W)

    def log_normalizer(self) -> torch.Tensor:
        d = self.dim
        sol, logdet = _spd_solve_logdet(self.W, self.xi[..., None])
        return 0.5 * (
            torch.einsum("...i,...i->...", self.xi, sol[..., 0]) + d * _LOG_2PI - logdet
        )

    def entropy(self) -> torch.Tensor:
        d = self.dim
        eye = torch.eye(d, dtype=self.W.dtype, device=self.W.device).expand(self.W.shape)
        _, logdet = _spd_solve_logdet(self.W, eye[..., :1])
        return 0.5 * (d * (1.0 + _LOG_2PI) - logdet)

    def logpdf(self, x) -> torch.Tensor:
        d = self.dim
        sol, logdet = _spd_solve_logdet(self.W, self.xi[..., None])
        diff = x - sol[..., 0]
        quad = torch.einsum("...i,...ij,...j->...", diff, self.W, diff)
        return -0.5 * (quad + d * _LOG_2PI - logdet)

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        chol = _cholesky_nan(self.cov)
        eps = torch.randn(
            tuple(shape) + tuple(self.xi.shape), generator=key,
            dtype=self.xi.dtype, device=self.xi.device,
        )
        return self.mean + torch.einsum("...ij,...j->...i", chol, eps)


def mv_from_mean_precision(mean, precision, device=None) -> MvGaussian:
    """Construct from (mean ``(..., d)``, precision ``(..., d, d)``)."""
    mean, precision = _tensors(mean, precision, device=device)
    xi = torch.einsum("...ij,...j->...i", precision, mean)
    return MvGaussian(xi, precision)


def mv_from_mean_cov(mean, cov, device=None) -> MvGaussian:
    """Construct from (mean ``(..., d)``, covariance ``(..., d, d)``)."""
    mean, cov = _tensors(mean, cov, device=device)
    return mv_from_mean_precision(mean, _spd_inv(cov))
