"""Nonlinear state-space smoothing: EKF and sigma-point (unscented) sweeps, in PyTorch.

The counterpart of ``cortex_tpu/ops/nonlinear.py``: projected Gaussian
message passing on a chain with user dynamics ``f`` and observations ``h``,
by linearization (EKF, Jacobians from ``torch.func.jacfwd``) or by moment
matching through 2d+1 sigma points (UKF), with the RTS backward sweep.

Model (vector state ``d``, vector observation ``m``):

    x_1 ~ N(m0, P0),  x_t = f(x_{t-1}) + N(0, Q),  y_t = h(x_t) + N(0, R)

``f: (d,) -> (d,)`` and ``h: (d,) -> (m,)`` act on one state.  The JAX
package vmaps the whole filter over replicas; here the filter carries the
replicas as a leading axis (means ``(B, d)``, covariances ``(B, d, d)``,
sigma points ``(B, 2d+1, d)``) and only the user's callables go through
``torch.func.vmap``, so the batched SPD eliminations of ``dists.gaussian``
run on whole batches.  The loop over time is a Python loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..dists.gaussian import _device, _spd_cholesky, _spd_solve_logdet
from ..utils.tree import as_float32_tensor

__all__ = [
    "NLSSMBeliefs",
    "ekf_filter",
    "ekf_smooth",
    "ukf_filter",
    "ukf_smooth",
]

_LOG2PI = math.log(2.0 * math.pi)


class NLSSMBeliefs(NamedTuple):
    """Gaussian beliefs over the states of a nonlinear chain.

    ``mean``: ``(..., T, d)``; ``cov``: ``(..., T, d, d)``;
    ``loglik``: ``(...,)`` — the (approximate) data log-evidence
    accumulated from the one-step prediction errors.
    """

    mean: torch.Tensor
    cov: torch.Tensor
    loglik: torch.Tensor


def _sym(P):
    return 0.5 * (P + P.mT)


def _gaussian_ll(v, S):
    """log N(v; 0, S) over a batch, by one pivotless SPD elimination."""
    sol, logdet = _spd_solve_logdet(S, v[..., None])
    return -0.5 * (v.shape[-1] * _LOG2PI + logdet + torch.sum(v * sol[..., 0], dim=-1))


def _inputs(y, Q, R, m0, P0):
    """``y`` as ``(B, T, m)`` on its device, the batch shape, and the model's
    arrays as tensors of ``y``'s dtype on that device."""
    dev = _device(y, Q, R, m0, P0)
    y = as_float32_tensor(y, dev)
    Q, R, m0, P0 = (torch.as_tensor(a, dtype=y.dtype, device=y.device) for a in (Q, R, m0, P0))
    batch_shape = tuple(y.shape[:-2])
    return y.reshape((-1,) + tuple(y.shape[-2:])), batch_shape, Q, R, m0, P0


def _outputs(batch_shape, mean, cov, loglik) -> NLSSMBeliefs:
    def back(a, core):
        return a.reshape(batch_shape + tuple(a.shape[a.ndim - core:]))

    return NLSSMBeliefs(back(mean, 2), back(cov, 3), back(loglik, 0))


def _forward(update, predict, y, m0, P0):
    """The filter's loop: ``update`` at t=0 from the prior, then
    ``predict`` and ``update`` at each later step.  Returns the filtered
    means and covariances ``(B, T, ...)``, the log evidence ``(B,)`` and the
    per-step smoother inputs ``(m_pred, P_pred, C)`` of steps 1..T-1."""
    B = y.shape[0]
    m, P, ll = update(m0.expand(B, -1), P0.expand(B, -1, -1), y[:, 0])
    means, covs, steps = [m], [P], []
    for t in range(1, y.shape[1]):
        m_pred, P_pred, C = predict(m, P)
        m, P, ll_t = update(m_pred, P_pred, y[:, t])
        ll = ll + ll_t
        means.append(m)
        covs.append(P)
        steps.append((m_pred, P_pred, C))
    return torch.stack(means, dim=1), torch.stack(covs, dim=1), ll, steps


def _rts_backward(mean, cov, steps):
    """RTS backward sweep from the filtered beliefs ``(B, T, ...)`` and each
    step's predictive moments and cross-covariance ``C_t = Cov[x_t,
    x_{t+1} | y_1:t]`` (EKF: ``P_f Fᵀ``; UKF: the sigma-point cross moment)."""
    m_s, P_s = mean[:, -1], cov[:, -1]
    ms, Ps = [m_s], [P_s]
    for t in range(mean.shape[1] - 2, -1, -1):
        m_pred, P_pred, C = steps[t]
        G = _spd_solve_logdet(P_pred, C.mT)[0].mT  # C P_pred⁻¹
        m_s = mean[:, t] + (G @ (m_s - m_pred)[..., None])[..., 0]
        P_s = _sym(cov[:, t] + G @ (P_s - P_pred) @ G.mT)
        ms.append(m_s)
        Ps.append(P_s)
    return torch.stack(ms[::-1], dim=1), torch.stack(Ps[::-1], dim=1)


# ---------------------------------------------------------------------------
# EKF
# ---------------------------------------------------------------------------


def _ekf_pass(f, h, Q, R, y, m0, P0):
    f_b, h_b = vmap(f), vmap(h)

    def jacobian(fn):
        # Forward mode gives a 0-dim float32 times a Python float a float64
        # tangent (torch 2.13): the Jacobian takes the state's dtype.
        jac = vmap(jacfwd(fn))
        return lambda m: jac(m).to(m.dtype)

    F_jac, H_jac = jacobian(f), jacobian(h)

    def update(m_pred, P_pred, obs):
        Hj = H_jac(m_pred)  # (B, m, d)
        v = obs - h_b(m_pred)
        S = _sym(Hj @ P_pred @ Hj.mT + R)
        K = _spd_solve_logdet(S, Hj @ P_pred)[0].mT  # P Hjᵀ S⁻¹ (S symmetric)
        m = m_pred + (K @ v[..., None])[..., 0]
        P = _sym(P_pred - K @ S @ K.mT)
        return m, P, _gaussian_ll(v, S)

    def predict(m, P):
        Fj = F_jac(m)
        C = P @ Fj.mT  # the smoother's cross-covariance of x_t, x_{t+1}
        return f_b(m), _sym(Fj @ C + Q), C

    return _forward(update, predict, y, m0, P0)


def ekf_filter(f, h, Q, R, y, m0, P0) -> NLSSMBeliefs:
    """Extended Kalman filtering: p(x_t | y_{1:t}) with first-order
    linearization at the running mean (Jacobians by ``torch.func.jacfwd``);
    ``y`` shaped ``(..., T, m)``, leading axes independent replicas."""
    y, batch_shape, Q, R, m0, P0 = _inputs(y, Q, R, m0, P0)
    mean, cov, ll, _ = _ekf_pass(f, h, Q, R, y, m0, P0)
    return _outputs(batch_shape, mean, cov, ll)


def ekf_smooth(f, h, Q, R, y, m0, P0) -> NLSSMBeliefs:
    """Extended RTS smoothing: p(x_t | y_{1:T})."""
    y, batch_shape, Q, R, m0, P0 = _inputs(y, Q, R, m0, P0)
    mean, cov, ll, steps = _ekf_pass(f, h, Q, R, y, m0, P0)
    return _outputs(batch_shape, *_rts_backward(mean, cov, steps), ll)


# ---------------------------------------------------------------------------
# UKF (scaled unscented transform, Merwe weights)
# ---------------------------------------------------------------------------


def _ut_weights(d, alpha, beta, kappa, like):
    lam = alpha * alpha * (d + kappa) - d
    c = d + lam
    rest = [1.0 / (2.0 * c)] * (2 * d)
    wm = torch.tensor([lam / c] + rest, dtype=like.dtype, device=like.device)
    wc = torch.tensor([lam / c + (1.0 - alpha * alpha + beta)] + rest,
                      dtype=like.dtype, device=like.device)
    return wm, wc, math.sqrt(c)


def _sigma_points(m, P, scale, jitter):
    """``(B, 2d+1, d)``: the mean, then the mean plus and minus each scaled
    Cholesky column."""
    d = m.shape[-1]
    L = _spd_cholesky(P + jitter * torch.eye(d, dtype=P.dtype, device=P.device))
    offsets = scale * L.mT  # rows are the scaled cholesky columns
    m = m[..., None, :]
    return torch.cat([m, m + offsets, m - offsets], dim=-2)


def _ut_moments(pts_in, pts_out, wm, wc, mean_in, noise):
    """Means, covariance and input-output cross-covariance of a transform."""
    mu = torch.einsum("s,...sd->...d", wm, pts_out)
    d_out = pts_out - mu[..., None, :]
    w_out = wc[:, None] * d_out
    cov = w_out.mT @ d_out + noise
    d_in = pts_in - mean_in[..., None, :]
    cross = (wc[:, None] * d_in).mT @ d_out
    return mu, _sym(cov), cross


def _through(fn, pts):
    """A per-state callable over ``(B, S, d)`` points."""
    B, S = pts.shape[:2]
    out = vmap(fn)(pts.reshape((B * S,) + tuple(pts.shape[2:])))
    return out.reshape((B, S) + tuple(out.shape[1:]))


def _ukf_pass(f, h, Q, R, y, m0, P0, alpha, beta, kappa, jitter):
    wm, wc, scale = _ut_weights(m0.shape[-1], alpha, beta, kappa, P0)

    def update(m_pred, P_pred, obs):
        pts = _sigma_points(m_pred, P_pred, scale, jitter)
        y_hat, S, Cxy = _ut_moments(pts, _through(h, pts), wm, wc, m_pred, R)
        v = obs - y_hat
        K = _spd_solve_logdet(S, Cxy.mT)[0].mT  # Cxy S⁻¹
        m = m_pred + (K @ v[..., None])[..., 0]
        P = _sym(P_pred - K @ S @ K.mT)
        return m, P, _gaussian_ll(v, S)

    def predict(m, P):
        pts = _sigma_points(m, P, scale, jitter)
        return _ut_moments(pts, _through(f, pts), wm, wc, m, Q)

    return _forward(update, predict, y, m0, P0)


def ukf_filter(
    f, h, Q, R, y, m0, P0, *, alpha=1.0, beta=2.0, kappa=0.0, jitter=1e-9
) -> NLSSMBeliefs:
    """Unscented Kalman filtering: moment matching through 2d+1 sigma points
    (scaled unscented transform) — exact for linear ``f``/``h``,
    derivative-free."""
    y, batch_shape, Q, R, m0, P0 = _inputs(y, Q, R, m0, P0)
    mean, cov, ll, _ = _ukf_pass(f, h, Q, R, y, m0, P0, alpha, beta, kappa, jitter)
    return _outputs(batch_shape, mean, cov, ll)


def ukf_smooth(
    f, h, Q, R, y, m0, P0, *, alpha=1.0, beta=2.0, kappa=0.0, jitter=1e-9
) -> NLSSMBeliefs:
    """Unscented RTS smoothing: the backward sweep uses the sigma-point
    cross-covariance for the smoother gain (Särkkä 2008)."""
    y, batch_shape, Q, R, m0, P0 = _inputs(y, Q, R, m0, P0)
    mean, cov, ll, steps = _ukf_pass(f, h, Q, R, y, m0, P0, alpha, beta, kappa, jitter)
    return _outputs(batch_shape, *_rts_backward(mean, cov, steps), ll)

