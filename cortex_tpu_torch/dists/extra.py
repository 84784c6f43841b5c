"""Additional exponential families, in PyTorch: NormalGamma, Wishart, Poisson.

The counterpart of ``cortex_tpu/dists/extra.py``: the GMM's Normal–Gamma
posterior as a first-class distribution, Wishart for full-covariance
components, Poisson for count models.  Each is a frozen dataclass of
tensors, batched over the leading axes.

``sample`` takes a ``torch.Generator`` named ``key`` on the values' device,
as the other families do; fields and arguments of Python floats or numpy
are taken as ``dists.conjugate`` takes them.  Gamma and chi-square draws use
the port's Marsaglia–Tsang sampler (PyTorch's own takes no generator);
Poisson draws come from ``torch.poisson``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch.special import digamma, gammaln

from ..utils.tree import as_operands, as_values
from .conjugate import _gamma_standard, _shape
from .gaussian import _cholesky_nan, _spd_inv, _spd_logdet

__all__ = ["NormalGamma", "Wishart", "Poisson"]

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


@dataclasses.dataclass(frozen=True)
class NormalGamma:
    """NormalGamma(m, beta, a, b): ``tau ~ Gamma(a, rate b)``,
    ``mu | tau ~ N(m, (beta tau)^-1)`` — the conjugate prior/posterior for a
    Gaussian with unknown mean and precision (used per dimension by the
    VB-GMM, :mod:`cortex_tpu_torch.models.gmm`)."""

    m: torch.Tensor
    beta: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor

    @property
    def mean_mu(self) -> torch.Tensor:
        return self.m

    @property
    def mean_tau(self) -> torch.Tensor:
        a, b = as_operands(self.a, self.b)
        return a / b

    def mean_log_tau(self) -> torch.Tensor:
        a, b = as_values(self.a, self.b, like=self)
        return digamma(a) - torch.log(b)

    def expected_tau_sq_diff(self, x) -> torch.Tensor:
        """E[tau (x − mu)²] = (a/b)(x − m)² + 1/beta."""
        m, beta, a, b, x = as_operands(self.m, self.beta, self.a, self.b, x)
        return a / b * (x - m) ** 2 + 1.0 / beta

    def __mul__(self, other: "NormalGamma") -> "NormalGamma":
        """Product of NormalGamma densities (natural-parameter addition)."""
        beta1, beta2 = as_operands(self.beta, other.beta)
        beta = beta1 + beta2
        m1, m2, w1, w2, w = as_operands(self.m, other.m, beta1, beta2, beta)
        m = (w1 * m1 + w2 * m2) / w
        a1, a2 = as_operands(self.a, other.a)
        cross = 0.5 * w1 * w2 / w * (m1 - m2) ** 2
        b1, b2, cross = as_operands(self.b, other.b, cross)
        return NormalGamma(m, beta, a1 + a2 + 0.5 - 1.0, b1 + b2 + cross)

    def entropy(self) -> torch.Tensor:
        beta, a, b = as_values(self.beta, self.a, self.b, like=self)
        h_tau = a - torch.log(b) + gammaln(a) + (1.0 - a) * digamma(a)
        h_mu = 0.5 * (1.0 + _LOG_2PI - (digamma(a) - torch.log(b)) - torch.log(beta))
        return h_tau + h_mu

    def kl(self, other: "NormalGamma") -> torch.Tensor:
        """KL(self ‖ other) in closed form."""
        m1, beta1, a1, b1, m2, beta2, a2, b2 = as_values(
            self.m, self.beta, self.a, self.b, other.m, other.beta, other.a, other.b)
        etau = a1 / b1
        # Gamma part.
        kl_tau = (
            (a1 - a2) * digamma(a1)
            - gammaln(a1)
            + gammaln(a2)
            + a2 * (torch.log(b1) - torch.log(b2))
            + a1 * (b2 - b1) / b1
        )
        # Conditional Gaussian part: E_tau KL(N(m1,(b1 t)^-1) || N(m2,(b2 t)^-1)).
        kl_mu = 0.5 * (torch.log(beta1 / beta2) + beta2 / beta1 - 1.0
                       + beta2 * etau * (m1 - m2) ** 2)
        return kl_tau + kl_mu

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()):
        """``(mu, tau)`` draws of shape ``shape + batch``."""
        m, beta, a, b = as_values(self.m, self.beta, self.a, self.b)
        tau = _gamma_standard(a, _shape(shape, a.shape), key) / b
        eps = torch.randn(tau.shape, generator=key, dtype=tau.dtype, device=tau.device)
        return m + eps / torch.sqrt(beta * tau), tau


@dataclasses.dataclass(frozen=True)
class Wishart:
    """Wishart(n, V): ``n`` degrees of freedom, scale ``V`` (..., d, d).

    Conjugate prior for a multivariate Gaussian precision matrix.
    """

    n: torch.Tensor
    V: torch.Tensor

    @property
    def dim(self) -> int:
        return self.V.shape[-1]

    @property
    def mean(self) -> torch.Tensor:
        n, V = as_operands(self.n, self.V)
        return n[..., None, None] * V

    def mean_logdet(self) -> torch.Tensor:
        """E[log |X|] = Σ ψ((n+1−i)/2) + d log2 + log|V|."""
        n, V = as_values(self.n, self.V)
        return (
            torch.sum(digamma((n[..., None] + 1.0 - _rows(V)) / 2.0), dim=-1)
            + self.dim * _LOG_2
            + _spd_logdet(V)
        )

    def __mul__(self, other: "Wishart") -> "Wishart":
        """Density product: add natural params (n' = n1+n2−d−1, V'⁻¹ = V1⁻¹+V2⁻¹)."""
        V1, V2 = as_values(self.V, other.V, like=(self.n, other.n))
        n1, n2 = as_operands(self.n, other.n)
        return Wishart(n1 + n2 - self.dim - 1.0, _spd_inv(_spd_inv(V1) + _spd_inv(V2)))

    def log_normalizer(self) -> torch.Tensor:
        n, V = as_values(self.n, self.V)
        d = self.dim
        return (
            0.5 * n * d * _LOG_2
            + 0.5 * n * _spd_logdet(V)
            + 0.25 * d * (d - 1) * math.log(math.pi)
            + torch.sum(gammaln((n[..., None] + 1.0 - _rows(V)) / 2.0), dim=-1)
        )

    def sample(self, key: torch.Generator) -> torch.Tensor:
        """One draw by the Bartlett decomposition: ``L A Aᵀ Lᵀ`` with ``L``
        the Cholesky factor of ``V`` and ``A`` lower triangular, chi-square
        draws (n − i degrees of freedom) on its diagonal under the square
        root and normal draws below it."""
        n, V = as_values(self.n, self.V)
        d = self.dim
        dtype, device = V.dtype, V.device
        chol = _cholesky_nan(V)
        df = n[..., None] - torch.arange(d, dtype=dtype, device=device)
        chi2 = 2.0 * _gamma_standard(df / 2.0, tuple(df.shape), key)
        normal = torch.randn(tuple(n.shape) + (d, d), generator=key, dtype=dtype,
                             device=device)
        eye = torch.eye(d, dtype=dtype, device=device)
        A = torch.tril(normal, -1) + eye * torch.sqrt(chi2)[..., None, :]
        LA = chol @ A
        return LA @ LA.transpose(-1, -2)


def _rows(V: torch.Tensor) -> torch.Tensor:
    """1, ..., d in ``V``'s dtype and on its device, for ``V`` (..., d, d)."""
    return torch.arange(1, V.shape[-1] + 1, dtype=V.dtype, device=V.device)


@dataclasses.dataclass(frozen=True)
class Poisson:
    """Poisson in natural form: ``log_rate``."""

    log_rate: torch.Tensor

    @classmethod
    def from_rate(cls, rate, device=None) -> "Poisson":
        return cls(torch.log(*as_values(rate, device=device)))

    @property
    def rate(self) -> torch.Tensor:
        return torch.exp(*as_values(self.log_rate))

    @property
    def mean(self) -> torch.Tensor:
        return self.rate

    @property
    def variance(self) -> torch.Tensor:
        return self.rate

    def __mul__(self, other: "Poisson") -> "Poisson":
        x, y = as_operands(self.log_rate, other.log_rate)
        return Poisson(x + y)

    def logpmf(self, k) -> torch.Tensor:
        log_rate, k = as_values(self.log_rate, k)
        return k * log_rate - torch.exp(log_rate) - gammaln(k + 1.0)

    def kl(self, other: "Poisson") -> torch.Tensor:
        x, y = as_values(self.log_rate, other.log_rate)
        r, ro = torch.exp(x), torch.exp(y)
        return r * (x - y) - r + ro

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """int32 counts of shape ``shape + batch``, as JAX draws them."""
        (log_rate,) = as_values(self.log_rate)
        rate = torch.exp(log_rate).expand(_shape(shape, log_rate.shape))
        return torch.poisson(rate, generator=key).to(torch.int32)
