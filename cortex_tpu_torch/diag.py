"""Failure detection for iterative inference.

As in the JAX package, for production inference loops:

- :func:`check_finite` — validate a tree of tensors for NaN/Inf, raising
  :class:`DivergenceError` naming the offending leaves by their paths,
- :class:`ConvergenceMonitor` — track a free-energy/ELBO series per replica
  on the host: detects divergence (NaN or sustained increase of free energy)
  and convergence (relative change below tolerance), vectorized across
  replicas so a single call covers a whole batch,
- :func:`rhat` and :func:`ess` — MCMC diagnostics on tensors, on the draws'
  device.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from .utils.tree import as_tensors, keystr, tree_flatten_with_path

__all__ = ["DivergenceError", "check_finite", "ConvergenceMonitor", "rhat", "ess"]


class DivergenceError(RuntimeError):
    """Raised when inference state becomes non-finite or diverges."""


def _non_finite(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return int((~torch.isfinite(leaf)).sum())
    return int((~np.isfinite(np.asarray(leaf))).sum())


def check_finite(tree: Any, where: str = "state") -> None:
    """Raise :class:`DivergenceError` if any leaf contains NaN/Inf.  Leaves
    are named by their paths as ``jax.tree_util.keystr`` writes them
    (``['bad']``, ``.mu1``, ``[0]``)."""
    bad: List[str] = []
    for path, leaf in tree_flatten_with_path(tree)[0]:
        n_bad = _non_finite(leaf)
        if n_bad:
            bad.append(f"{keystr(path)} ({n_bad} non-finite)")
    if bad:
        raise DivergenceError(
            f"Non-finite values in {where}: " + ", ".join(bad[:5])
        )


class ConvergenceMonitor:
    """Track per-replica free energy across iterations.

    ``update(fe)`` with ``fe`` of shape ``(...,)`` (one value per replica;
    a tensor on any device or an array) returns a boolean numpy array: True
    where converged.  ``diverged`` flags replicas whose free energy is NaN or
    increased for ``patience`` consecutive updates (VB free energy must be
    non-increasing; an increase signals a broken update or numerical
    failure).  The series is kept on the host in float64.
    """

    def __init__(self, rtol: float = 1e-6, atol: float = 1e-9, patience: int = 3):
        self.rtol = rtol
        self.atol = atol
        self.patience = patience
        self._last: Optional[np.ndarray] = None
        self._rise_count: Optional[np.ndarray] = None
        self.history: List[np.ndarray] = []

    def update(self, fe) -> np.ndarray:
        if isinstance(fe, torch.Tensor):
            fe = fe.detach().cpu().numpy()
        fe = np.asarray(fe, dtype=np.float64)
        self.history.append(fe)
        if self._last is None:
            self._last = fe
            self._rise_count = np.zeros(fe.shape, dtype=np.int64)
            return np.zeros(fe.shape, dtype=bool)
        delta = fe - self._last
        rising = delta > self.atol
        self._rise_count = np.where(rising, self._rise_count + 1, 0)
        converged = np.abs(delta) <= self.atol + self.rtol * np.abs(self._last)
        self._last = fe
        return converged

    @property
    def diverged(self) -> np.ndarray:
        if self._last is None:
            raise RuntimeError("No updates recorded")
        return ~np.isfinite(self._last) | (self._rise_count >= self.patience)

    def raise_if_diverged(self, where: str = "inference") -> None:
        d = self.diverged
        if d.any():
            raise DivergenceError(
                f"{int(d.sum())} replica(s) diverged during {where} "
                f"(free energy rising {self.patience}+ iterations or non-finite)"
            )


def rhat(chains: torch.Tensor) -> torch.Tensor:
    """Split-R̂ convergence diagnostic (Gelman–Rubin, rank-free variant).

    ``chains``: ``(M, N, ...)`` — M chains of N draws of arbitrary-shaped
    quantities; returns R̂ per quantity, shape ``(...)``.  Values near 1
    indicate the chains agree; > 1.01 is the conventional warning level.
    Each chain is split in half (catching within-chain drift), then
    R̂² = (W·(n−1)/n + B/n) / W with B/W the between/within variances.
    An array that is not a tensor becomes float32 on the card.
    """
    x, = as_tensors(chains)
    half = x.shape[1] // 2
    x = torch.cat([x[:, :half], x[:, half : 2 * half]], dim=0)  # (2M, half, ...)
    chain_means = torch.mean(x, dim=1)
    chain_vars = torch.var(x, dim=1, correction=1)
    w = torch.mean(chain_vars, dim=0)
    b = half * torch.var(chain_means, dim=0, correction=1)
    var_plus = w * (half - 1) / half + b / half
    return torch.sqrt(var_plus / w)


def ess(chains: torch.Tensor, max_lag: int = 200) -> torch.Tensor:
    """Effective sample size from M×N draws (Geyer initial-positive-sequence
    truncation on the chain-averaged autocorrelation).

    ``chains``: ``(M, N)`` scalar draws (apply per quantity); returns a
    scalar ESS ≤ M·N.  IID draws give ≈ M·N; an AR(1) chain with
    coefficient φ gives ≈ M·N·(1−φ)/(1+φ).  Input as :func:`rhat` takes it.
    """
    x, = as_tensors(chains)
    m, n = x.shape
    max_lag = min(max_lag, n - 1)
    xc = x - torch.mean(x, dim=1, keepdim=True)
    # Autocovariance by FFT, as the JAX package computes it.
    f = torch.fft.rfft(xc, n=2 * n, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=1)[:, : max_lag + 1] / n
    rhos = torch.mean(acov[:, 1:] / torch.clamp(acov[:, :1], min=1e-30), dim=0)
    # Geyer: sum consecutive pairs; truncate at the first negative pair-sum.
    n_pairs = max_lag // 2
    pair = rhos[: 2 * n_pairs].reshape(n_pairs, 2).sum(dim=1)
    keep = torch.cumprod((pair > 0).to(pair.dtype), dim=0)  # 1 until the first negative pair
    tau = 1.0 + 2.0 * torch.sum(pair * keep)
    return m * n / torch.clamp(tau, min=1.0)
