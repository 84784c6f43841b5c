"""Conjugate exponential families, in PyTorch.

The counterpart of ``cortex_tpu/dists/conjugate.py``.  So far it holds the
Dirichlet, which the HMM's variational message passing needs: batched over
the leading axes, closed under ``*`` (density product) and ``/`` (cavity
quotient), with moments, log normalizer, entropy and KL divergence.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.special import digamma, gammaln

__all__ = ["Dirichlet"]


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
