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

``sample(key, shape)`` takes a ``torch.Generator`` on the values' device.
PyTorch's own Gamma, Beta and Dirichlet samplers take no generator, so Gamma
draws are made here by Marsaglia and Tsang's method, and Beta and Dirichlet
draws from them.  Constructors given Python or numpy values make float32
tensors, on the card unless the caller names another ``device``.

A dataclass holds what it is given, as the JAX one does.  Its methods take
fields and arguments of Python floats or numpy as the JAX package's do:
converted (``as_values``: float32, on the first tensor's device, else the
card) where JAX's first ``jnp`` call converts them, and left to numpy where
JAX computes in plain numpy arithmetic (``as_operands``: ``mean`` and
``variance`` of numpy fields, ``*`` and ``/`` of two numpy Betas, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.special import digamma, gammaln

from ..utils.tree import as_operands, as_values

__all__ = ["Beta", "Gamma", "Bernoulli", "Categorical", "Dirichlet"]


def betaln(a, b):
    """log B(a, b) = log Γ(a) + log Γ(b) − log Γ(a + b)."""
    return gammaln(a) + gammaln(b) - gammaln(a + b)


def _softplus(x):
    """log(1 + eˣ), as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


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
        a, b = as_operands(self.a, self.b)
        return a / (a + b)

    @property
    def variance(self) -> torch.Tensor:
        a, b = as_operands(self.a, self.b)
        s = a + b
        return a * b / (s * s * (s + 1.0))

    def __mul__(self, other: "Beta") -> "Beta":
        a1, a2 = as_operands(self.a, other.a)
        b1, b2 = as_operands(self.b, other.b)
        return Beta(a1 + a2 - 1.0, b1 + b2 - 1.0)

    @classmethod
    def reduce_product(cls, stacked: "Beta", axis: int = 0) -> "Beta":
        """Product of k stacked Betas in ONE reduction: pairwise ``*`` is
        associative with the affine correction −(k−1) on both shapes."""
        a, b = as_values(stacked.a, stacked.b)
        k = a.shape[axis]
        return cls(torch.sum(a, axis) - (k - 1.0), torch.sum(b, axis) - (k - 1.0))

    def __truediv__(self, other: "Beta") -> "Beta":
        a1, a2 = as_operands(self.a, other.a)
        b1, b2 = as_operands(self.b, other.b)
        return Beta(a1 - a2 + 1.0, b1 - b2 + 1.0)

    def log_normalizer(self) -> torch.Tensor:
        return betaln(*as_values(self.a, self.b))

    def logpdf(self, x) -> torch.Tensor:
        a, b, x = as_values(self.a, self.b, x)
        return (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) - betaln(a, b)

    def entropy(self) -> torch.Tensor:
        a, b = as_values(self.a, self.b)
        return (
            betaln(a, b)
            - (a - 1.0) * digamma(a)
            - (b - 1.0) * digamma(b)
            + (a + b - 2.0) * digamma(a + b)
        )

    def kl(self, other: "Beta") -> torch.Tensor:
        """KL(self ‖ other)."""
        a1, b1, a2, b2 = as_values(self.a, self.b, other.a, other.b)
        return (
            betaln(a2, b2)
            - betaln(a1, b1)
            + (a1 - a2) * digamma(a1)
            + (b1 - b2) * digamma(b1)
            + (a2 - a1 + b2 - b1) * digamma(a1 + b1)
        )

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        a, b = as_values(self.a, self.b)
        batch = torch.broadcast_shapes(a.shape, b.shape)
        x = _gamma_standard(a, _shape(shape, batch), key)
        y = _gamma_standard(b, _shape(shape, batch), key)
        return x / (x + y)


@dataclasses.dataclass(frozen=True)
class Gamma:
    """Gamma(shape α, rate β).  ``mean = α/β``."""

    shape: torch.Tensor
    rate: torch.Tensor

    @classmethod
    def from_shape_scale(cls, shape, scale, device=None) -> "Gamma":
        shape, scale = as_values(shape, scale, device=device)
        return cls(shape, 1.0 / scale)

    @property
    def scale(self) -> torch.Tensor:
        return 1.0 / self.rate

    @property
    def mean(self) -> torch.Tensor:
        shape, rate = as_operands(self.shape, self.rate)
        return shape / rate

    @property
    def variance(self) -> torch.Tensor:
        shape, rate = as_operands(self.shape, self.rate)
        return shape / (rate * rate)

    def mean_log(self) -> torch.Tensor:
        """E[log x] = ψ(α) − log β (used by VMP precision updates)."""
        shape, rate = as_values(self.shape, self.rate)
        return digamma(shape) - torch.log(rate)

    def __mul__(self, other: "Gamma") -> "Gamma":
        a1, a2 = as_operands(self.shape, other.shape)
        b1, b2 = as_operands(self.rate, other.rate)
        return Gamma(a1 + a2 - 1.0, b1 + b2)

    @classmethod
    def reduce_product(cls, stacked: "Gamma", axis: int = 0) -> "Gamma":
        """Product of k stacked Gammas in ONE reduction (Σα − (k−1), Σβ)."""
        shape, rate = as_values(stacked.shape, stacked.rate)
        k = shape.shape[axis]
        return cls(torch.sum(shape, axis) - (k - 1.0), torch.sum(rate, axis))

    def __truediv__(self, other: "Gamma") -> "Gamma":
        a1, a2 = as_operands(self.shape, other.shape)
        b1, b2 = as_operands(self.rate, other.rate)
        return Gamma(a1 - a2 + 1.0, b1 - b2)

    def log_normalizer(self) -> torch.Tensor:
        a, b = as_values(self.shape, self.rate)
        return gammaln(a) - a * torch.log(b)

    def logpdf(self, x) -> torch.Tensor:
        a, b, x = as_values(self.shape, self.rate, x)
        return a * torch.log(b) - gammaln(a) + (a - 1.0) * torch.log(x) - b * x

    def entropy(self) -> torch.Tensor:
        a, b = as_values(self.shape, self.rate)
        return a - torch.log(b) + gammaln(a) + (1.0 - a) * digamma(a)

    def kl(self, other: "Gamma") -> torch.Tensor:
        """KL(self ‖ other)."""
        a1, b1, a2, b2 = as_values(self.shape, self.rate, other.shape, other.rate)
        return (
            (a1 - a2) * digamma(a1)
            - gammaln(a1)
            + gammaln(a2)
            + a2 * (torch.log(b1) - torch.log(b2))
            + a1 * (b2 - b1) / b1
        )

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        alpha, rate = as_values(self.shape, self.rate)
        return _gamma_standard(alpha, _shape(shape, alpha.shape), key) / rate


@dataclasses.dataclass(frozen=True)
class Bernoulli:
    """Bernoulli in log-odds (natural) form: ``logit = log(p/(1−p))``."""

    logit: torch.Tensor

    @classmethod
    def from_prob(cls, p, device=None) -> "Bernoulli":
        (p,) = as_values(p, device=device)
        return cls(torch.log(p) - torch.log1p(-p))

    @property
    def prob(self) -> torch.Tensor:
        return torch.sigmoid(*as_values(self.logit))

    @property
    def mean(self) -> torch.Tensor:
        return self.prob

    @property
    def variance(self) -> torch.Tensor:
        p = self.prob
        return p * (1.0 - p)

    def __mul__(self, other: "Bernoulli") -> "Bernoulli":
        x, y = as_operands(self.logit, other.logit)
        return Bernoulli(x + y)

    @classmethod
    def reduce_product(cls, stacked: "Bernoulli", axis: int = 0) -> "Bernoulli":
        """Product of k stacked Bernoullis in ONE reduction (Σ logit)."""
        return cls(torch.sum(*as_values(stacked.logit), axis))

    def __truediv__(self, other: "Bernoulli") -> "Bernoulli":
        x, y = as_operands(self.logit, other.logit)
        return Bernoulli(x - y)

    def log_normalizer(self) -> torch.Tensor:
        return _softplus(*as_values(self.logit))

    def entropy(self) -> torch.Tensor:
        p = self.prob
        return -(p * torch.log(p) + (1.0 - p) * torch.log1p(-p))

    def kl(self, other: "Bernoulli") -> torch.Tensor:
        """KL(self ‖ other) via the softplus log-normalizers."""
        x, y = as_values(self.logit, other.logit)
        return torch.sigmoid(x) * (x - y) - _softplus(x) + _softplus(y)

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        (logit,) = as_values(self.logit)
        u = torch.rand(_shape(shape, logit.shape), generator=key, dtype=logit.dtype,
                       device=logit.device)
        return u < torch.sigmoid(logit)


@dataclasses.dataclass(frozen=True)
class Categorical:
    """Categorical over K classes in unnormalized log-probability form.

    ``logits``: ``(..., K)``.  Messages multiply by adding logits; the
    normalizer is tracked implicitly (``log_normalizer`` = logsumexp).
    """

    logits: torch.Tensor

    @classmethod
    def from_probs(cls, p, device=None) -> "Categorical":
        return cls(torch.log(*as_values(p, device=device)))

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(*as_values(self.logits), dim=-1)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    def __mul__(self, other: "Categorical") -> "Categorical":
        x, y = as_operands(self.logits, other.logits)
        return Categorical(x + y)

    @classmethod
    def reduce_product(cls, stacked: "Categorical", axis: int = 0) -> "Categorical":
        """Product of k stacked Categoricals in ONE reduction (Σ logits)."""
        return cls(torch.sum(*as_values(stacked.logits), axis))

    def __truediv__(self, other: "Categorical") -> "Categorical":
        x, y = as_operands(self.logits, other.logits)
        return Categorical(x - y)

    def log_normalizer(self) -> torch.Tensor:
        return torch.logsumexp(*as_values(self.logits), dim=-1)

    def entropy(self) -> torch.Tensor:
        (logits,) = as_values(self.logits)
        p = torch.softmax(logits, dim=-1)
        logp = F.log_softmax(logits, dim=-1)
        return -torch.sum(p * logp, dim=-1)

    def kl(self, other: "Categorical") -> torch.Tensor:
        x, y = as_values(self.logits, other.logits)
        p = torch.softmax(x, dim=-1)
        return torch.sum(p * (F.log_softmax(x, dim=-1) - F.log_softmax(y, dim=-1)), dim=-1)

    def sample(self, key: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Class indices of shape ``shape + logits.shape[:-1]``, int32 as JAX
        returns them, by the Gumbel-max trick."""
        (logits,) = as_values(self.logits)
        u = torch.rand(_shape(shape, logits.shape), generator=key, dtype=logits.dtype,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Dirichlet:
    """Dirichlet(α) over the simplex, ``alpha``: ``(..., K)``."""

    alpha: torch.Tensor

    @property
    def mean(self) -> torch.Tensor:
        (alpha,) = as_values(self.alpha)
        return alpha / torch.sum(alpha, dim=-1, keepdim=True)

    def mean_log(self) -> torch.Tensor:
        """E[log x_k] = ψ(α_k) − ψ(Σα) (drives Categorical VMP messages)."""
        (alpha,) = as_values(self.alpha)
        return digamma(alpha) - digamma(torch.sum(alpha, dim=-1, keepdim=True))

    def __mul__(self, other: "Dirichlet") -> "Dirichlet":
        a1, a2 = as_operands(self.alpha, other.alpha)
        return Dirichlet(a1 + a2 - 1.0)

    @classmethod
    def reduce_product(cls, stacked: "Dirichlet", axis: int = 0) -> "Dirichlet":
        """Product of k stacked Dirichlets in ONE reduction (Σα − (k−1))."""
        (alpha,) = as_values(stacked.alpha)
        return cls(torch.sum(alpha, dim=axis) - (alpha.shape[axis] - 1.0))

    def __truediv__(self, other: "Dirichlet") -> "Dirichlet":
        a1, a2 = as_operands(self.alpha, other.alpha)
        return Dirichlet(a1 - a2 + 1.0)

    def log_normalizer(self) -> torch.Tensor:
        (alpha,) = as_values(self.alpha)
        return torch.sum(gammaln(alpha), dim=-1) - gammaln(torch.sum(alpha, dim=-1))

    def entropy(self) -> torch.Tensor:
        (a,) = as_values(self.alpha)
        a0 = torch.sum(a, dim=-1)
        k = a.shape[-1]
        return (
            Dirichlet(a).log_normalizer()
            + (a0 - k) * digamma(a0)
            - torch.sum((a - 1.0) * digamma(a), dim=-1)
        )

    def kl(self, other: "Dirichlet") -> torch.Tensor:
        """KL(self ‖ other) along the last axis."""
        a1, a2 = as_values(self.alpha, other.alpha)
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
        (alpha,) = as_values(self.alpha)
        g = _gamma_standard(alpha, _shape(shape, alpha.shape), key)
        return g / torch.sum(g, dim=-1, keepdim=True)
