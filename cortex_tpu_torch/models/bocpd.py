"""Bayesian online changepoint detection (BOCPD, Adams & MacKay 2007), in PyTorch.

The counterpart of ``cortex_tpu/models/bocpd.py``: the run-length posterior
p(r_t | y_1:t) propagated with conjugate predictive likelihoods and a
constant hazard.  The run-length axis is statically truncated to ``r_max``,
so each step is a handful of elementwise operations on ``(..., r_max)``
state plus one ``logsumexp``, batched over leading replica axes; the loop
over time is a Python loop.

Observation families (both conjugate, per run-length hypothesis):

- :class:`GaussianNIG` — unknown mean & variance, Normal-Inverse-Gamma
  prior, Student-t predictive;
- :class:`BernoulliBeta` — unknown rate, Beta prior, Beta-Bernoulli
  predictive.

Truncation: run lengths ≥ ``r_max - 1`` accumulate in the last bin.  Mass is
merged exactly (``logaddexp``); the bin's sufficient statistics follow the
higher-mass branch.  With ``r_max > T`` the filter is exact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Union

import torch

from ..dists.gaussian import _device
from ..utils.tree import as_float32_tensor

__all__ = ["BOCPD", "GaussianNIG", "BernoulliBeta", "BOCPDResult"]


@dataclasses.dataclass(frozen=True)
class GaussianNIG:
    """Normal-Inverse-Gamma conjugate observation model.

    Sufficient statistics are accumulated *centered at the prior mean* —
    ``(n, Σ(y−μ0), Σ(y−μ0)²)`` — so ``beta`` below is a sum of
    near-positive terms; raw ``(Σy, Σy²)`` accumulation cancels
    catastrophically in float32 once ``|mean|/std ≳ 1e3`` over long runs.
    """

    mu0: float = 0.0
    kappa0: float = 1.0
    alpha0: float = 1.0
    beta0: float = 1.0

    def init_stats(self, shape, dtype, device=None):
        z = torch.zeros(shape, dtype=dtype, device=device)
        return (z, z, z)  # (n, Σ(y−μ0), Σ(y−μ0)²)

    def update_stats(self, stats, y):
        n, s, q = stats
        yc = y[..., None] - self.mu0
        return (n + 1.0, s + yc, q + yc * yc)

    def pred_logpdf(self, stats, y):
        n, s, q = stats
        y = y[..., None]
        kappa = self.kappa0 + n
        delta = s / kappa  # = mu − mu0; division-safe (kappa ≥ kappa0 > 0)
        mu = self.mu0 + delta
        alpha = self.alpha0 + 0.5 * n
        # beta0 + 0.5(q̃ − s̃·δ): each term ≥ 0 (Cauchy–Schwarz), no
        # cancellation.
        beta = self.beta0 + 0.5 * (q - s * delta)
        # Student-t(2*alpha, mu, beta*(kappa+1)/(alpha*kappa)) log pdf.
        nu = 2.0 * alpha
        scale2 = beta * (kappa + 1.0) / (alpha * kappa)
        z2 = (y - mu) ** 2 / scale2
        return (
            torch.lgamma(0.5 * (nu + 1.0))
            - torch.lgamma(0.5 * nu)
            - 0.5 * torch.log(nu * math.pi * scale2)
            - 0.5 * (nu + 1.0) * torch.log1p(z2 / nu)
        )


@dataclasses.dataclass(frozen=True)
class BernoulliBeta:
    """Beta-Bernoulli conjugate observation model (y ∈ {0, 1})."""

    a0: float = 1.0
    b0: float = 1.0

    def init_stats(self, shape, dtype, device=None):
        z = torch.zeros(shape, dtype=dtype, device=device)
        return (z, z)  # (#ones, #zeros)

    def update_stats(self, stats, y):
        ones, zeros = stats
        y = y[..., None]
        return (ones + y, zeros + (1.0 - y))

    def pred_logpdf(self, stats, y):
        ones, zeros = stats
        y = y[..., None]
        p1 = (self.a0 + ones) / (self.a0 + self.b0 + ones + zeros)
        return torch.where(y > 0.5, torch.log(p1), torch.log1p(-p1))


class BOCPDResult(NamedTuple):
    """Outputs per time step (leading axes = replica batch, then T)."""

    run_length_logprobs: torch.Tensor  # (..., T, r_max): log p(r_t | y_1:t)
    # p(r_t <= 1 | y_1:t): the run began within the last two steps.  Note
    # p(r_t = 0) alone is *identically the hazard* under a constant-hazard
    # prior, so the earliest data-driven evidence of a change appears in the
    # r = 1 bin.
    changepoint_prob: torch.Tensor  # (..., T)
    log_evidence: torch.Tensor  # (...,): log p(y_1:T)
    map_run_length: torch.Tensor  # (..., T): argmax_r p(r_t | y_1:t)


@dataclasses.dataclass(frozen=True)
class BOCPD:
    """Online changepoint filter with constant hazard ``1/expected_run``.

    ``obs_model`` supplies conjugate sufficient-statistic recursions and the
    posterior-predictive log pdf; ``r_max`` is the static truncation of the
    run-length axis.
    """

    obs_model: Union[GaussianNIG, BernoulliBeta] = GaussianNIG()
    hazard: float = 0.01
    r_max: int = 256

    def filter(self, y) -> BOCPDResult:
        """Filter ``y`` of shape ``(..., T)``; returns run-length posteriors."""
        y = as_float32_tensor(y, _device(y))
        dtype = torch.promote_types(y.dtype, torch.float32)
        y = y.to(dtype)
        batch_shape, T, R = tuple(y.shape[:-1]), y.shape[-1], self.r_max
        log_h = math.log(self.hazard)
        log_1mh = math.log1p(-self.hazard)

        # r_0 = 0 with probability 1.
        logw = torch.full(batch_shape + (R,), -math.inf, dtype=dtype, device=y.device)
        logw[..., 0] = 0.0
        fresh = self.obs_model.init_stats(logw.shape, dtype, y.device)
        stats = fresh
        log_Z = torch.zeros(batch_shape, dtype=dtype, device=y.device)
        logws = torch.empty(batch_shape + (T, R), dtype=dtype, device=y.device)
        for t in range(T):
            y_t = y[..., t]
            joint = logw + self.obs_model.pred_logpdf(stats, y_t)  # log p(r_{t-1}, y_1:t)

            # Growth: r -> r+1 (last bin absorbs overflow mass).  Changepoint:
            # all mass routes to r = 0.
            grow = joint + log_1mh
            change = torch.logsumexp(joint + log_h, dim=-1, keepdim=True)
            last = torch.logaddexp(grow[..., -2:-1], grow[..., -1:])
            log_joint = torch.cat([change, grow[..., : R - 2], last], dim=-1)
            step_Z = torch.logsumexp(log_joint, dim=-1)
            logw = log_joint - step_Z[..., None]
            logws[..., t, :] = logw
            log_Z = log_Z + step_Z

            # Sufficient statistics follow the same shift: bin r+1 inherits
            # bin r updated with y_t; bin 0 resets to the prior.  The merged
            # last bin takes the higher-mass branch's statistics.
            upd = self.obs_model.update_stats(stats, y_t)
            keep_last = (grow[..., -1] > grow[..., -2])[..., None]
            stats = tuple(
                torch.cat([f[..., :1], u[..., : R - 2],
                           torch.where(keep_last, u[..., -1:], u[..., -2:-1])], dim=-1)
                for f, u in zip(fresh, upd)
            )
        return BOCPDResult(
            run_length_logprobs=logws,
            changepoint_prob=torch.exp(logws[..., 0]) + torch.exp(logws[..., 1]),
            log_evidence=log_Z,
            map_run_length=torch.argmax(logws, dim=-1),
        )
