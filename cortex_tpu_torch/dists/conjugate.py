"""Conjugate exponential families, in PyTorch: Beta, Gamma, Bernoulli,
Categorical, Dirichlet.

The counterpart of ``cortex_tpu/dists/conjugate.py``.  Each family is a frozen
dataclass of tensors, batched over the leading axes, closed under ``*``
(density product) and ``/`` (cavity quotient), with moments, log normalizer,
entropy, KL divergence, a stacked ``reduce_product`` and sampling:

- Beta product: ``Beta(a1+a2−1, b1+b2−1)``,
- Gamma product: ``Gamma(α1+α2−1, rate1+rate2)``,
- Categorical/Bernoulli product: add log-probabilities,
- Dirichlet product: ``Dir(α1+α2−1)``.

``sample(key, shape)`` takes a ``torch.Generator`` on the tensors' device.
PyTorch's own Gamma, Beta and Dirichlet samplers take no generator, so Gamma
draws are made here by Marsaglia and Tsang's method, and Beta and Dirichlet
draws from them.  Constructors given Python or numpy values make float32
tensors, on the card unless the caller names another ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.special import digamma, gammaln

from ..utils.tree import as_float32_tensor

__all__ = ["Beta", "Gamma", "Bernoulli", "Categorical", "Dirichlet"]


def betaln(a, b):
    """log B(a, b) = log Γ(a) + log Γ(b) − log Γ(a + b)."""
    return gammaln(a) + gammaln(b) - gammaln(a + b)


def _softplus(x):
    """log(1 + eˣ), as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _new_tensor(x, device):
    if device is None and not isinstance(x, torch.Tensor):
        device = "cuda"
    return as_float32_tensor(x, device)


def _shape(shape, batch):
    return tuple(shape) + tuple(batch)


def _gamma_standard(alpha, shape, key):
    """Draws of Gamma(``alpha``, rate 1) of ``shape`` (``alpha`` broadcast
    to it), by Marsaglia and Tsang's method: ``d·v`` with ``v = (1 + c x)³``
    for a normal ``x``, accepted when ``log u < x²/2 + d − d v + d log v``.
    Shapes below 1 draw at ``alpha + 1`` and scale by ``u^(1/alpha)``."""
    alpha = alpha.expand(shape)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.ones_like(a)
    done = torch.zeros(shape, dtype=torch.bool, device=a.device)
    while not bool(done.all()):
        x = torch.randn(shape, generator=key, dtype=a.dtype, device=a.device)
        u = torch.rand(shape, generator=key, dtype=a.dtype, device=a.device)
        v = (1.0 + c * x) ** 3
        log_v = torch.log(torch.clamp(v, min=torch.finfo(a.dtype).tiny))
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v) & ~done
        out = torch.where(ok, d * v, out)
        done = done | ok
    u = torch.rand(shape, generator=key, dtype=a.dtype, device=a.device)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


@dataclasses.dataclass(frozen=True)
class Beta:
    """Beta(a, b) with shape parameters stored directly."""

    a: torch.Tensor
    b: torch.Tensor

    @property
    def mean(self) -> torch.Tensor:
        return self.a / (self.a + self.b)

    @property
    def variance(self) -> torch.Tensor:
        s = self.a + self.b
        return self.a * self.b / (s * s * (s + 1.0))

    def __mul__(self, other: "Beta") -> "Beta":
        return Beta(self.a + other.a - 1.0, self.b + other.b - 1.0)

    @classmethod
    def reduce_product(cls, stacked: "Beta", axis: int = 0) -> "Beta":
        """Product of k stacked Betas in ONE reduction: pairwise ``*`` is
        associative with the affine correction −(k−1) on both shapes."""
        k = stacked.a.shape[axis]
        return cls(
            torch.sum(stacked.a, axis) - (k - 1.0),
            torch.sum(stacked.b, axis) - (k - 1.0),
        )

    def __truediv__(self, other: "Beta") -> "Beta":
        return Beta(self.a - other.a + 1.0, self.b - other.b + 1.0)

    def log_normalizer(self) -> torch.Tensor:
        return betaln(self.a, self.b)

    def logpdf(self, x) -> torch.Tensor:
        return (
            (self.a - 1.0) * torch.log(x)
            + (self.b - 1.0) * torch.log1p(-x)
            - betaln(self.a, self.b)
        )

    def entropy(self) -> torch.Tensor:
        a, b = self.a, self.b
        return (
            betaln(a, b)
            - (a - 1.0) * digamma(a)
            - (b - 1.0) * digamma(b)
            + (a + b - 2.0) * digamma(a + b)
        )

    def kl(self, other: "Beta") -> torch.Tensor:
        """KL(self ‖ other)."""
        a1, b1, a2, b2 = self.a, self.b, other.a, other.b
        return (
            betaln(a2, b2)
            - betaln(a1, b1)
            + (a1 - a2) * digamma(a1)
            + (b1 - b2) * digamma(b1)
            + (a2 - a1 + b2 - b1) * digamma(a1 + b1)
        )

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        batch = torch.broadcast_shapes(self.a.shape, self.b.shape)
        x = _gamma_standard(self.a, _shape(shape, batch), key)
        y = _gamma_standard(self.b, _shape(shape, batch), key)
        return x / (x + y)


@dataclasses.dataclass(frozen=True)
class Gamma:
    """Gamma(shape α, rate β).  ``mean = α/β``."""

    shape: torch.Tensor
    rate: torch.Tensor

    @classmethod
    def from_shape_scale(cls, shape, scale, device=None) -> "Gamma":
        shape = _new_tensor(shape, device)
        scale = _new_tensor(scale, shape.device)
        return cls(shape, 1.0 / scale)

    @property
    def scale(self) -> torch.Tensor:
        return 1.0 / self.rate

    @property
    def mean(self) -> torch.Tensor:
        return self.shape / self.rate

    @property
    def variance(self) -> torch.Tensor:
        return self.shape / (self.rate * self.rate)

    def mean_log(self) -> torch.Tensor:
        """E[log x] = ψ(α) − log β (used by VMP precision updates)."""
        return digamma(self.shape) - torch.log(self.rate)

    def __mul__(self, other: "Gamma") -> "Gamma":
        return Gamma(self.shape + other.shape - 1.0, self.rate + other.rate)

    @classmethod
    def reduce_product(cls, stacked: "Gamma", axis: int = 0) -> "Gamma":
        """Product of k stacked Gammas in ONE reduction (Σα − (k−1), Σβ)."""
        k = stacked.shape.shape[axis]
        return cls(
            torch.sum(stacked.shape, axis) - (k - 1.0),
            torch.sum(stacked.rate, axis),
        )

    def __truediv__(self, other: "Gamma") -> "Gamma":
        return Gamma(self.shape - other.shape + 1.0, self.rate - other.rate)

    def log_normalizer(self) -> torch.Tensor:
        return gammaln(self.shape) - self.shape * torch.log(self.rate)

    def logpdf(self, x) -> torch.Tensor:
        return (
            self.shape * torch.log(self.rate)
            - gammaln(self.shape)
            + (self.shape - 1.0) * torch.log(x)
            - self.rate * x
        )

    def entropy(self) -> torch.Tensor:
        a = self.shape
        return a - torch.log(self.rate) + gammaln(a) + (1.0 - a) * digamma(a)

    def kl(self, other: "Gamma") -> torch.Tensor:
        """KL(self ‖ other)."""
        a1, b1, a2, b2 = self.shape, self.rate, other.shape, other.rate
        return (
            (a1 - a2) * digamma(a1)
            - gammaln(a1)
            + gammaln(a2)
            + a2 * (torch.log(b1) - torch.log(b2))
            + a1 * (b2 - b1) / b1
        )

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        batch = self.shape.shape
        return _gamma_standard(self.shape, _shape(shape, batch), key) / self.rate


@dataclasses.dataclass(frozen=True)
class Bernoulli:
    """Bernoulli in log-odds (natural) form: ``logit = log(p/(1−p))``."""

    logit: torch.Tensor

    @classmethod
    def from_prob(cls, p, device=None) -> "Bernoulli":
        p = _new_tensor(p, device)
        return cls(torch.log(p) - torch.log1p(-p))

    @property
    def prob(self) -> torch.Tensor:
        return torch.sigmoid(self.logit)

    @property
    def mean(self) -> torch.Tensor:
        return self.prob

    @property
    def variance(self) -> torch.Tensor:
        p = self.prob
        return p * (1.0 - p)

    def __mul__(self, other: "Bernoulli") -> "Bernoulli":
        return Bernoulli(self.logit + other.logit)

    @classmethod
    def reduce_product(cls, stacked: "Bernoulli", axis: int = 0) -> "Bernoulli":
        """Product of k stacked Bernoullis in ONE reduction (Σ logit)."""
        return cls(torch.sum(stacked.logit, axis))

    def __truediv__(self, other: "Bernoulli") -> "Bernoulli":
        return Bernoulli(self.logit - other.logit)

    def log_normalizer(self) -> torch.Tensor:
        return _softplus(self.logit)

    def entropy(self) -> torch.Tensor:
        p = self.prob
        return -(p * torch.log(p) + (1.0 - p) * torch.log1p(-p))

    def kl(self, other: "Bernoulli") -> torch.Tensor:
        """KL(self ‖ other) via the softplus log-normalizers."""
        p = self.prob
        return p * (self.logit - other.logit) - _softplus(self.logit) + _softplus(other.logit)

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        u = torch.rand(_shape(shape, self.logit.shape), generator=key,
                       dtype=self.logit.dtype, device=self.logit.device)
        return u < self.prob


@dataclasses.dataclass(frozen=True)
class Categorical:
    """Categorical over K classes in unnormalized log-probability form.

    ``logits``: ``(..., K)``.  Messages multiply by adding logits; the
    normalizer is tracked implicitly (``log_normalizer`` = logsumexp).
    """

    logits: torch.Tensor

    @classmethod
    def from_probs(cls, p, device=None) -> "Categorical":
        return cls(torch.log(_new_tensor(p, device)))

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    def __mul__(self, other: "Categorical") -> "Categorical":
        return Categorical(self.logits + other.logits)

    @classmethod
    def reduce_product(cls, stacked: "Categorical", axis: int = 0) -> "Categorical":
        """Product of k stacked Categoricals in ONE reduction (Σ logits)."""
        return cls(torch.sum(stacked.logits, axis))

    def __truediv__(self, other: "Categorical") -> "Categorical":
        return Categorical(self.logits - other.logits)

    def log_normalizer(self) -> torch.Tensor:
        return torch.logsumexp(self.logits, dim=-1)

    def entropy(self) -> torch.Tensor:
        p = self.probs
        logp = F.log_softmax(self.logits, dim=-1)
        return -torch.sum(p * logp, dim=-1)

    def kl(self, other: "Categorical") -> torch.Tensor:
        p = self.probs
        return torch.sum(
            p * (F.log_softmax(self.logits, dim=-1) - F.log_softmax(other.logits, dim=-1)),
            dim=-1,
        )

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Class indices of shape ``shape + logits.shape[:-1]``, by the
        Gumbel-max trick."""
        u = torch.rand(_shape(shape, self.logits.shape), generator=key,
                       dtype=self.logits.dtype, device=self.logits.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(self.logits + gumbel, dim=-1)


@dataclasses.dataclass(frozen=True)
class Dirichlet:
    """Dirichlet(α) over the simplex, ``alpha``: ``(..., K)``."""

    alpha: torch.Tensor

    @property
    def mean(self) -> torch.Tensor:
        return self.alpha / torch.sum(self.alpha, dim=-1, keepdim=True)

    def mean_log(self) -> torch.Tensor:
        """E[log x_k] = ψ(α_k) − ψ(Σα) (drives Categorical VMP messages)."""
        return digamma(self.alpha) - digamma(torch.sum(self.alpha, dim=-1, keepdim=True))

    def __mul__(self, other: "Dirichlet") -> "Dirichlet":
        return Dirichlet(self.alpha + other.alpha - 1.0)

    @classmethod
    def reduce_product(cls, stacked: "Dirichlet", axis: int = 0) -> "Dirichlet":
        """Product of k stacked Dirichlets in ONE reduction (Σα − (k−1))."""
        k = stacked.alpha.shape[axis]
        return cls(torch.sum(stacked.alpha, dim=axis) - (k - 1.0))

    def __truediv__(self, other: "Dirichlet") -> "Dirichlet":
        return Dirichlet(self.alpha - other.alpha + 1.0)

    def log_normalizer(self) -> torch.Tensor:
        return torch.sum(gammaln(self.alpha), dim=-1) - gammaln(torch.sum(self.alpha, dim=-1))

    def entropy(self) -> torch.Tensor:
        a = self.alpha
        a0 = torch.sum(a, dim=-1)
        k = a.shape[-1]
        return (
            self.log_normalizer()
            + (a0 - k) * digamma(a0)
            - torch.sum((a - 1.0) * digamma(a), dim=-1)
        )

    def kl(self, other: "Dirichlet") -> torch.Tensor:
        """KL(self ‖ other) along the last axis."""
        a1, a2 = self.alpha, other.alpha
        s1 = torch.sum(a1, dim=-1)
        return (
            gammaln(s1)
            - torch.sum(gammaln(a1), dim=-1)
            - gammaln(torch.sum(a2, dim=-1))
            + torch.sum(gammaln(a2), dim=-1)
            + torch.sum((a1 - a2) * (digamma(a1) - digamma(s1)[..., None]), dim=-1)
        )

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Points on the simplex of shape ``shape + alpha.shape``: normalized
        Gamma(α_k, 1) draws."""
        g = _gamma_standard(self.alpha, _shape(shape, self.alpha.shape), key)
        return g / torch.sum(g, dim=-1, keepdim=True)
