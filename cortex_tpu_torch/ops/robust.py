"""Robust (Student-t observation) LGSSM smoothing — variational outlier rejection, in PyTorch.

The counterpart of ``cortex_tpu/ops/robust.py``.  Heavy-tailed observation
noise ``y_t = H x_t + t_ν(0, R)`` written as a Gaussian scale mixture
``y_t | w_t ~ N(H x_t, R / w_t)``, ``w_t ~ Gamma(ν/2, ν/2)``, and solved by
mean-field VB coordinate ascent:

  E-step (weights):  E[w_t] = (ν + 1) / (ν + E[(y_t − H x_t)²] / R)
  M-step (states):   one Gaussian smoothing sweep with per-step
                     observation precision  w_t · H²/R

The state update is the information-form chain sweep
(:func:`cortex_tpu_torch.ops.chains._info_form_smooth`) with reweighted
observation messages; the JAX ``lax.fori_loop`` over VB iterations is a
Python loop.  An outlier's weight collapses toward ``(ν+1)/(ν + z²)`` ≈ 0;
ν → ∞ recovers the standard smoother.  The converged weights double as
per-step outlier scores (small = outlier).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .chains import _info_form_smooth, _inputs

__all__ = ["RobustChainResult", "robust_lgssm_smooth"]


class RobustChainResult(NamedTuple):
    """Posterior marginals plus the VB observation weights (outlier scores:
    E[w_t] ≈ 1 for inliers, → 0 for gross outliers)."""

    mean: torch.Tensor  # (..., T)
    variance: torch.Tensor  # (..., T)
    weights: torch.Tensor  # (..., T)


def robust_lgssm_smooth(
    y: torch.Tensor,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    nu: float = 4.0,
    n_iters: int = 15,
    prior: Optional[Tuple[object, object]] = None,
) -> RobustChainResult:
    """VB smoothing of a scalar chain under Student-t_ν observation noise.

    Same contract as :func:`cortex_tpu_torch.ops.chains.lgssm_smooth_scan`
    (``y``: ``(..., T)``, NaN = missing, optional prior on ``x_1``) plus the
    tail parameter ``nu`` (ν → ∞ ⇒ Gaussian) and the VB iteration count.
    """
    y, prior = _inputs(y, prior)
    observed = ~torch.isnan(y)
    y = torch.where(observed, y, 0.0)
    yT = y.movedim(-1, 0)  # (T, ...)
    obsT = observed.movedim(-1, 0)
    w_base = torch.where(obsT, torch.as_tensor((H * H) / R, dtype=y.dtype, device=y.device), 0.0)

    def sweep(weights):
        xi_obs = torch.where(obsT, weights * H * yT / R, 0.0)
        return _info_form_smooth(xi_obs, weights * w_base, A, Q, prior)

    weights = torch.ones_like(yT)
    for _ in range(n_iters):
        marg = sweep(weights)
        mT = marg.mean.movedim(-1, 0)
        vT = marg.variance.movedim(-1, 0)
        # E[(y − Hx)²] under the smoothed marginal; the variance at fully
        # unobserved steps can be inf — masked steps keep weight 1.
        resid2 = (yT - H * mT) ** 2 + H * H * torch.where(obsT, vT, 0.0)
        weights = torch.where(obsT, (nu + 1.0) / (nu + resid2 / R), 1.0)
    marg = sweep(weights)
    return RobustChainResult(marg.mean, marg.variance, weights.movedim(0, -1).contiguous())
