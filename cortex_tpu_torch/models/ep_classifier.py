"""Bayesian linear classification via parallel EP — probit and logistic, in PyTorch.

The counterpart of ``cortex_tpu/models/ep_classifier.py``: a Gaussian
posterior over the weights of ``p(y=+1 | x) = link(x·w)`` by
:func:`~cortex_tpu_torch.ops.ep.ep_linear_model`, and predictive
probabilities that integrate over it.  Probit sites are moment-matched in
closed form, logistic sites by Gauss–Hermite quadrature.

Predictives: with ``z* = x*·w``, ``q(z*) = N(μ*, σ*²)``:
- probit: exact — ``p(+1) = Φ(μ*/√(1+σ*²))``,
- logistic: Gauss–Hermite over ``σ(z*) N(z*; μ*, σ*²)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dists.gaussian import _device
from ..ops.ep import EPResult, ep_linear_model, gauss_hermite_tilted, probit_tilted_moments
from ..utils.tree import as_float32_tensor
from .glm import _latent

__all__ = ["EPClassifier", "EPClassifierPosterior"]


class EPClassifierPosterior(NamedTuple):
    """Fitted weight posterior ``N(mean, cov)`` plus the predictive link."""

    mean: torch.Tensor
    cov: torch.Tensor
    ep: EPResult
    likelihood: str

    def latent(self, Xs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Latent predictive ``q(z*) = N(μ*, σ*²)`` at ``(m, d)`` inputs."""
        return _latent(self.mean, self.cov, Xs)

    def predict_proba(self, Xs) -> torch.Tensor:
        """``p(y=+1 | x*)`` integrated over the weight posterior."""
        mu, var = self.latent(Xs)
        if self.likelihood == "probit":
            return torch.special.ndtr(mu / torch.sqrt(1.0 + var))
        nodes, weights = np.polynomial.hermite_e.hermegauss(31)
        z = mu[:, None] + torch.sqrt(var)[:, None] * torch.tensor(
            nodes, dtype=mu.dtype, device=mu.device)
        w = torch.tensor(weights / np.sqrt(2.0 * np.pi), dtype=mu.dtype, device=mu.device)
        return torch.sum(torch.sigmoid(z) * w[None, :], dim=-1)

    def predict(self, Xs) -> torch.Tensor:
        """Hard labels in {-1, +1}."""
        p = self.predict_proba(Xs)
        return torch.where(p >= 0.5, 1.0, -1.0).to(p.dtype)


@dataclasses.dataclass(frozen=True)
class EPClassifier:
    """Bayesian linear classifier ``y ∈ {-1,+1}``, ``p(y|x) = link(y·x·w)``.

    ``likelihood``: ``"probit"`` (closed-form EP sites) or ``"logistic"``
    (Gauss–Hermite sites).  ``prior_var`` is the isotropic weight prior.
    """

    likelihood: str = "probit"
    prior_var: float = 1.0
    n_iters: int = 40
    damping: float = 0.8

    def fit(self, X, y) -> EPClassifierPosterior:
        """``X``: ``(n, d)``; ``y``: ``(n,)`` in {-1, +1}."""
        dev = _device(X, y)
        X = torch.atleast_2d(as_float32_tensor(X, dev))
        y = as_float32_tensor(y, dev)
        if self.likelihood == "probit":
            tilted = probit_tilted_moments(y)
        elif self.likelihood == "logistic":
            tilted = gauss_hermite_tilted(lambda z: F.logsigmoid(y[:, None] * z))
        else:
            raise ValueError(
                f"unknown likelihood {self.likelihood!r}; expected 'probit' or 'logistic'"
            )
        ep = ep_linear_model(X, tilted, prior_var=self.prior_var, n_iters=self.n_iters,
                             damping=self.damping)
        return EPClassifierPosterior(ep.mean, ep.cov, ep, self.likelihood)
