"""Additional exponential families, in PyTorch: NormalGamma, Wishart, Poisson.

The counterpart of ``cortex_tpu/dists/extra.py``: the GMM's Normal–Gamma
posterior as a first-class distribution, Wishart for full-covariance
components, Poisson for count models.  Each is a frozen dataclass of
tensors, batched over the leading axes.

``sample`` takes a ``torch.Generator`` named ``key`` on the tensors' device,
as the other families do.  Gamma and chi-square draws use the port's
Marsaglia–Tsang sampler (PyTorch's own takes no generator); Poisson draws
come from ``torch.poisson``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch.special import digamma, gammaln

from .conjugate import _gamma_standard, _new_tensor, _shape
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
        return self.a / self.b

    def mean_log_tau(self) -> torch.Tensor:
        return digamma(self.a) - torch.log(self.b)

    def expected_tau_sq_diff(self, x) -> torch.Tensor:
        """E[tau (x − mu)²] = (a/b)(x − m)² + 1/beta."""
        return self.mean_tau * (x - self.m) ** 2 + 1.0 / self.beta

    def __mul__(self, other: "NormalGamma") -> "NormalGamma":
        """Product of NormalGamma densities (natural-parameter addition)."""
        beta = self.beta + other.beta
        m = (self.beta * self.m + other.beta * other.m) / beta
        a = self.a + other.a + 0.5 - 1.0
        cross = 0.5 * self.beta * other.beta / beta * (self.m - other.m) ** 2
        b = self.b + other.b + cross
        return NormalGamma(m, beta, a, b)

    def entropy(self) -> torch.Tensor:
        h_tau = self.a - torch.log(self.b) + gammaln(self.a) + (1.0 - self.a) * digamma(self.a)
        h_mu = 0.5 * (1.0 + _LOG_2PI - self.mean_log_tau() - torch.log(self.beta))
        return h_tau + h_mu

    def kl(self, other: "NormalGamma") -> torch.Tensor:
        """KL(self ‖ other) in closed form."""
        etau = self.mean_tau
        # Gamma part.
        kl_tau = (
            (self.a - other.a) * digamma(self.a)
            - gammaln(self.a)
            + gammaln(other.a)
            + other.a * (torch.log(self.b) - torch.log(other.b))
            + self.a * (other.b - self.b) / self.b
        )
        # Conditional Gaussian part: E_tau KL(N(m1,(b1 t)^-1) || N(m2,(b2 t)^-1)).
        kl_mu = 0.5 * (
            torch.log(self.beta / other.beta)
            + other.beta / self.beta
            - 1.0
            + other.beta * etau * (self.m - other.m) ** 2
        )
        return kl_tau + kl_mu

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()):
        """``(mu, tau)`` draws of shape ``shape + batch``."""
        tau = _gamma_standard(self.a, _shape(shape, self.a.shape), key) / self.b
        eps = torch.randn(tau.shape, generator=key, dtype=tau.dtype, device=tau.device)
        return self.m + eps / torch.sqrt(self.beta * tau), tau


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
        return self.n[..., None, None] * self.V

    def _i(self) -> torch.Tensor:
        return torch.arange(1, self.dim + 1, dtype=self.V.dtype, device=self.V.device)

    def mean_logdet(self) -> torch.Tensor:
        """E[log |X|] = Σ ψ((n+1−i)/2) + d log2 + log|V|."""
        return (
            torch.sum(digamma((self.n[..., None] + 1.0 - self._i()) / 2.0), dim=-1)
            + self.dim * _LOG_2
            + _spd_logdet(self.V)
        )

    def __mul__(self, other: "Wishart") -> "Wishart":
        """Density product: add natural params (n' = n1+n2−d−1, V'⁻¹ = V1⁻¹+V2⁻¹)."""
        Vinv = _spd_inv(self.V) + _spd_inv(other.V)
        return Wishart(self.n + other.n - self.dim - 1.0, _spd_inv(Vinv))

    def log_normalizer(self) -> torch.Tensor:
        d = self.dim
        return (
            0.5 * self.n * d * _LOG_2
            + 0.5 * self.n * _spd_logdet(self.V)
            + 0.25 * d * (d - 1) * math.log(math.pi)
            + torch.sum(gammaln((self.n[..., None] + 1.0 - self._i()) / 2.0), dim=-1)
        )

    def sample(self, key: torch.Generator) -> torch.Tensor:
        """One draw by the Bartlett decomposition: ``L A Aᵀ Lᵀ`` with ``L``
        the Cholesky factor of ``V`` and ``A`` lower triangular, chi-square
        draws (n − i degrees of freedom) on its diagonal under the square
        root and normal draws below it."""
        d = self.dim
        dtype, device = self.V.dtype, self.V.device
        chol = _cholesky_nan(self.V)
        df = self.n[..., None] - torch.arange(d, dtype=dtype, device=device)
        chi2 = 2.0 * _gamma_standard(df / 2.0, tuple(df.shape), key)
        normal = torch.randn(tuple(self.n.shape) + (d, d), generator=key, dtype=dtype,
                             device=device)
        eye = torch.eye(d, dtype=dtype, device=device)
        A = torch.tril(normal, -1) + eye * torch.sqrt(chi2)[..., None, :]
        LA = chol @ A
        return LA @ LA.transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class Poisson:
    """Poisson in natural form: ``log_rate``."""

    log_rate: torch.Tensor

    @classmethod
    def from_rate(cls, rate, device=None) -> "Poisson":
        return cls(torch.log(_new_tensor(rate, device)))

    @property
    def rate(self) -> torch.Tensor:
        return torch.exp(self.log_rate)

    @property
    def mean(self) -> torch.Tensor:
        return self.rate

    @property
    def variance(self) -> torch.Tensor:
        return self.rate

    def __mul__(self, other: "Poisson") -> "Poisson":
        return Poisson(self.log_rate + other.log_rate)

    def logpmf(self, k) -> torch.Tensor:
        return k * self.log_rate - self.rate - gammaln(k + 1.0)

    def kl(self, other: "Poisson") -> torch.Tensor:
        r, ro = self.rate, other.rate
        return r * (self.log_rate - other.log_rate) - r + ro

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """int32 counts of shape ``shape + batch``, as JAX draws them."""
        rate = self.rate.expand(_shape(shape, self.log_rate.shape))
        return torch.poisson(rate, generator=key).to(torch.int32)
