"""Probabilistic PCA and Factor Analysis — latent linear-Gaussian models, in PyTorch.

The counterpart of ``cortex_tpu/models/ppca.py``: everything is a dense
product.  The E-step posterior ``M = WᵀW + σ²I`` is a q×q solve; the heavy
work is ``Yᵀ(YW...)`` Gram products of shape (d, n)×(n, q), O(ndq) an
iteration, the loop over iterations a Python loop.

- :func:`ppca_closed_form` — Tipping & Bishop (1999) exact ML via
  ``eigh``.  Eigenvector signs differ between libraries; ``W Wᵀ``, ``σ²``
  and the log-likelihood do not.
- :class:`PPCA` ``.fit_em`` — EM, ``.log_likelihood`` via the Woodbury /
  q-space determinant lemma, ``.transform`` posterior latents.
- :class:`FactorAnalysis` ``.fit_em`` — per-dimension noise ``psi``.

The default EM start is a randomized range finder whose Gaussian test
matrix comes from a ``torch.Generator`` (``key``; ``None`` takes a CPU
generator seeded with 0, the same start on any device); both models take
``init`` to start elsewhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..dists.gaussian import _cholesky_nan, _device
from ..utils.tree import as_float32_tensor
from .fit import _trace

__all__ = ["PPCA", "PPCAResult", "FactorAnalysis", "FAResult", "ppca_closed_form"]

_LOG_2PI = math.log(2.0 * math.pi)


class PPCAResult(NamedTuple):
    W: torch.Tensor  # (d, q) loadings
    sigma2: torch.Tensor  # () isotropic noise variance
    mu: torch.Tensor  # (d,) data mean
    log_likelihood: torch.Tensor  # (n_iters,) trace (EM) or () (closed form)


class FAResult(NamedTuple):
    W: torch.Tensor  # (d, q)
    psi: torch.Tensor  # (d,) diagonal noise variances
    mu: torch.Tensor  # (d,)
    log_likelihood: torch.Tensor  # (n_iters,)


def _data(Y) -> torch.Tensor:
    return as_float32_tensor(Y, _device(Y))


def _check_components(q: int, d: int, extra: str = "") -> None:
    if not 0 < q < d:
        raise ValueError(f"n_components must satisfy 0 < q < d (got q={q}, d={d}){extra}")


def _marginal_loglik_iso(Yc, W, sigma2):
    """Σ_i log N(y_i; 0, WWᵀ + σ²I) in q-space (Woodbury + det lemma)."""
    n, d = Yc.shape
    q = W.shape[1]
    L = _cholesky_nan(W.T @ W + sigma2 * torch.eye(q, dtype=W.dtype, device=W.device))
    # log|C| = (d-q) log σ² + log|M|
    logdet = (d - q) * torch.log(sigma2) + 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    # tr(Yc C⁻¹ Ycᵀ) = (||Yc||² - ||L⁻¹ Wᵀ Ycᵀ||²) / σ².  Subtract *per
    # sample* before the global sum: the two global sums are O(n·d) while
    # their difference is O(quad), so subtracting afterwards cancels
    # catastrophically in float32.
    half = torch.linalg.solve_triangular(L, W.T @ Yc.T, upper=False)  # (q, n)
    per_sample = torch.sum(Yc * Yc, dim=1) - torch.sum(half * half, dim=0)
    quad = torch.sum(per_sample) / sigma2
    return -0.5 * (n * d * _LOG_2PI + n * logdet + quad)


def ppca_closed_form(Y, n_components: int) -> PPCAResult:
    """Exact ML PPCA (Tipping & Bishop 1999, §3.2) via ``eigh``.

    ``W = U_q (Λ_q − σ²I)^{1/2}``, ``σ² = mean of the d−q trailing
    eigenvalues`` of the sample covariance.  O(d³) — for very large d
    prefer :meth:`PPCA.fit_em`.
    """
    Y = _data(Y)
    n, d = Y.shape
    q = n_components
    _check_components(q, d, "; the isotropic noise estimate averages the d−q trailing "
                            "eigenvalues and is undefined at q = d.")
    mu = Y.mean(dim=0)
    Yc = Y - mu
    S = (Yc.T @ Yc) / n
    evals, evecs = torch.linalg.eigh(S)  # ascending
    lam_q = torch.flip(evals[-q:], dims=[0])
    U_q = torch.flip(evecs[:, -q:], dims=[1])
    sigma2 = evals[: d - q].sum() / (d - q)
    W = U_q * torch.sqrt(torch.clamp(lam_q - sigma2, min=0.0))
    return PPCAResult(W=W, sigma2=sigma2, mu=mu, log_likelihood=_marginal_loglik_iso(Yc, W, sigma2))


def _range_finder(Yc, q: int, key: Optional[torch.Generator]):
    """Randomized range-finder start: one power iteration of the sample
    covariance (two products, never materializing d×d) and a QR, scaled by
    per-column Rayleigh quotients.  Returns ``(Q_init, lam)``."""
    n, d = Yc.shape
    if key is None:
        key = torch.Generator().manual_seed(0)
    omega = torch.randn((d, q), generator=key, dtype=Yc.dtype, device=key.device).to(Yc.device)
    B = Yc.T @ (Yc @ omega) / n  # = S @ omega
    Q_init, _ = torch.linalg.qr(B)
    lam = torch.sum((Yc @ Q_init) ** 2, dim=0) / n
    return Q_init, lam


@dataclasses.dataclass(frozen=True)
class PPCA:
    """Isotropic-noise probabilistic PCA with EM fitting.

    ``y_i = W z_i + mu + ε``, ``z_i ~ N(0, I_q)``, ``ε ~ N(0, σ²I_d)``.
    """

    n_components: int

    def fit_em(
        self,
        Y,
        n_iters: int = 100,
        key: Optional[torch.Generator] = None,
        init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> PPCAResult:
        """EM over (W, σ²) from ``init = (W0, σ²0)`` or the range-finder start
        drawn with ``key``; returns the fit plus the per-iteration marginal
        log-likelihood trace (monotonically non-decreasing)."""
        Y = _data(Y)
        n, d = Y.shape
        q = self.n_components
        _check_components(q, d)
        mu = Y.mean(dim=0)
        Yc = Y - mu

        if init is not None:
            W = as_float32_tensor(init[0], Y.device).to(Y.dtype)
            sigma2 = torch.as_tensor(init[1], dtype=Y.dtype, device=Y.device)
        else:
            # EM from a random start crawls when σ² is small relative to the
            # spectral gaps; starting in the right subspace cuts iterations.
            Q_init, lam = _range_finder(Yc, q, key)
            sigma2 = torch.clamp((torch.sum(Yc * Yc) / n - lam.sum()) / (d - q), min=1e-6)
            W = Q_init * torch.sqrt(torch.clamp(lam - sigma2, min=1e-6))

        eye_q = torch.eye(q, dtype=Y.dtype, device=Y.device)
        lls = []
        for _ in range(n_iters):
            # E-step in q-space: M = WᵀW + σ²I (q×q).
            Minv = torch.linalg.inv(W.T @ W + sigma2 * eye_q)
            # Sufficient statistics: S_yz = Ycᵀ E[Z] (d, q); S_zz = Σ E[z zᵀ].
            EZ = (Yc @ W) @ Minv  # (n, q)
            S_yz = Yc.T @ EZ
            S_zz = n * sigma2 * Minv + EZ.T @ EZ
            # M-step.
            W_new = torch.linalg.solve(S_zz.T, S_yz.T).T  # S_yz @ S_zz⁻¹
            # Noise update in residual form — a sum of positives: the
            # subtractive form cancels catastrophically in float32.
            resid = Yc - EZ @ W_new.T
            sigma2 = (torch.sum(resid * resid)
                      + n * sigma2 * torch.sum((W_new @ Minv) * W_new)) / (n * d)
            W = W_new
            lls.append(_marginal_loglik_iso(Yc, W, sigma2))
        return PPCAResult(W=W, sigma2=sigma2, mu=mu, log_likelihood=_trace(lls, Y))

    def log_likelihood(self, Y, result: PPCAResult) -> torch.Tensor:
        return _marginal_loglik_iso(_data(Y) - result.mu, result.W, result.sigma2)

    def transform(self, Y, result: PPCAResult):
        """Posterior latents: mean (n, q) and shared covariance (q, q)."""
        q = self.n_components
        eye = torch.eye(q, dtype=result.W.dtype, device=result.W.device)
        Minv = torch.linalg.inv(result.W.T @ result.W + result.sigma2 * eye)
        mean = (_data(Y) - result.mu) @ result.W @ Minv
        return mean, result.sigma2 * Minv


@dataclasses.dataclass(frozen=True)
class FactorAnalysis:
    """Factor analysis: diagonal per-dimension noise ``psi`` (d,)."""

    n_components: int

    def fit_em(
        self,
        Y,
        n_iters: int = 200,
        key: Optional[torch.Generator] = None,
        init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> FAResult:
        """EM over (W, psi) from ``init = (W0, psi0)`` or the range-finder
        start drawn with ``key`` (psi from the residual variance, floored)."""
        Y = _data(Y)
        n, d = Y.shape
        q = self.n_components
        _check_components(q, d)
        mu = Y.mean(dim=0)
        Yc = Y - mu
        diag_ss = torch.sum(Yc * Yc, dim=0) / n  # (d,)

        if init is not None:
            W = as_float32_tensor(init[0], Y.device).to(Y.dtype)
            psi = as_float32_tensor(init[1], Y.device).to(Y.dtype)
        else:
            Q_init, lam = _range_finder(Yc, q, key)
            iso = torch.clamp((diag_ss.sum() - lam.sum()) / (d - q), min=1e-6)
            W = Q_init * torch.sqrt(torch.clamp(lam - iso, min=1e-6))
            # Relative floor: starting a dimension at (near-)zero noise is a
            # Heywood-boundary start that float32 EM cannot escape.
            psi = torch.maximum(diag_ss - torch.sum(W * W, dim=1), 0.05 * diag_ss)
        psi_floor = 1e-6 * diag_ss
        eye_q = torch.eye(q, dtype=Y.dtype, device=Y.device)

        def loglik(W, psi):
            # q-space determinant/Woodbury with C = diag(psi) + WWᵀ.
            Wp = W / psi[:, None]
            L = _cholesky_nan(eye_q + W.T @ Wp)
            logdet = torch.sum(torch.log(psi)) + 2.0 * torch.sum(torch.log(torch.diagonal(L)))
            Yp = Yc / torch.sqrt(psi)
            half = torch.linalg.solve_triangular(L, Wp.T @ Yc.T, upper=False)  # (q, n)
            # Per-sample subtraction: see _marginal_loglik_iso.
            quad = torch.sum(torch.sum(Yp * Yp, dim=1) - torch.sum(half * half, dim=0))
            return -0.5 * (n * d * _LOG_2PI + n * logdet + quad)

        lls = []
        for _ in range(n_iters):
            Wp = W / psi[:, None]
            Minv = torch.linalg.inv(eye_q + W.T @ Wp)  # posterior covariance (q, q)
            EZ = (Yc @ Wp) @ Minv  # (n, q)
            S_yz = Yc.T @ EZ
            S_zz = n * Minv + EZ.T @ EZ
            W_new = torch.linalg.solve(S_zz.T, S_yz.T).T
            # Residual form (see PPCA.fit_em): float32-safe, positive by
            # construction.
            resid = Yc - EZ @ W_new.T
            psi = torch.maximum(
                torch.sum(resid * resid, dim=0) / n + torch.sum((W_new @ Minv) * W_new, dim=1),
                psi_floor)
            W = W_new
            lls.append(loglik(W, psi))
        return FAResult(W=W, psi=psi, mu=mu, log_likelihood=_trace(lls, Y))
