"""Chain message passing (Kalman smoothing) over scalar LGSSM chains, in PyTorch.

The PyTorch counterpart of ``cortex_tpu/ops/chains.py``: the same functions,
arguments and results, written as plain tensor code.  Leading axes of ``y``
are replica batches and the last axis is time.  A ``lax.scan`` over time is
a Python loop here, each step updating every replica at once.

- :func:`lgssm_smooth_scan` — forward and backward message recursions in
  information form, with an optional prior and NaN gaps.
- :func:`lgssm_smooth_matmul` — the smoother as one affine map,
  ``mean = y @ S + c``, in full float32 (TF32 off).
- :func:`lgssm_smooth_assoc` — the time-parallel smoother of Särkkä and
  García-Fernández (2020) over a log-depth (Hillis–Steele) scan.

All three return the Belief-Propagation marginals of every state:

    marginal_t = obs_message_t · forward_message_t · backward_message_t

Model (scalar state, per batch element):

    x_t = A x_{t-1} + N(0, Q),    y_t = H x_t + N(0, R)
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "ChainMarginals",
    "lgssm_smooth_scan",
    "lgssm_smooth_assoc",
    "lgssm_smooth_matmul",
    "lgssm_smoother_operator",
    "lgssm_messages_scan",
    "scalar_kalman_update",
]

Prior = Tuple[object, object]


def scalar_kalman_update(obs, m_pred, v_pred, H=1.0, R=1.0):
    """Scalar Kalman measurement update, elementwise over any batch shape.

    Returns ``(m_filt, v_filt, loglik)`` with
    ``loglik = log N(obs; H·m_pred, H²·v_pred + R)``.
    """
    s = H * H * v_pred + R
    ll = -0.5 * (torch.log(2.0 * math.pi * s) + (obs - H * m_pred) ** 2 / s)
    g = v_pred * H / s
    m = m_pred + g * (obs - H * m_pred)
    v = v_pred - g * H * v_pred
    return m, v, ll


class ChainMarginals(NamedTuple):
    """Posterior marginals of each state: tensors shaped like ``y``."""

    mean: torch.Tensor
    variance: torch.Tensor


def _obs_message(y, H, R):
    """Information-form observation message into x_t: xi = H y / R, w = H²/R.

    Missing observations (NaN) carry zero information: xi = w = 0, which the
    division-safe message projections below propagate exactly.
    """
    observed = ~torch.isnan(y)
    xi = H * torch.where(observed, y, 0.0) / R
    w = observed.to(y.dtype) * ((H * H) / R)
    return xi, w


def lgssm_smooth_scan(
    y: torch.Tensor,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    prior: Optional[Prior] = None,
) -> ChainMarginals:
    """BP smoothing of a scalar LGSSM chain by a forward and a backward pass.

    ``y`` has shape ``(..., T)``; NaN entries are missing observations.
    ``prior`` is an optional ``(mean, variance)`` message on ``x_1`` (floats
    or tensors of the batch shape); ``None`` puts no prior factor on the
    first state.  Returns ``ChainMarginals`` of shape ``(..., T)``.
    """
    yT = y.movedim(-1, 0)  # (T, ...batch)
    xi_obs, w_obs = _obs_message(yT, H, R)
    return _info_form_smooth(xi_obs, w_obs, A, Q, prior)


def _info_form_smooth(xi_obs, w_obs, A, Q, prior):
    """Forward/backward sweep over information-form observation messages of
    shape ``(T, ...batch)``."""
    T = xi_obs.shape[0]
    if prior is not None:
        pm, pv = prior
        xi_c, w_c = xi_obs[0] + pm / pv, w_obs[0] + 1.0 / pv
    else:
        xi_c, w_c = xi_obs[0], w_obs[0]

    # Forward pass: carry the filtered belief, store the forward *message*
    # into each state (zero information into x_1).  The projection through
    # x_t = A x_{t-1} + N(0,Q) is in the division-safe rational form, valid
    # at w = 0 (a run of missing observations):
    #   w_msg = w / (A² + Q w),  xi_msg = A xi / (A² + Q w).
    xi_fwd = torch.zeros_like(xi_obs)
    w_fwd = torch.zeros_like(w_obs)
    for t in range(1, T):
        denom = A * A + Q * w_c
        xi_fwd[t] = A * xi_c / denom
        w_fwd[t] = w_c / denom
        xi_c = xi_fwd[t] + xi_obs[t]
        w_c = w_fwd[t] + w_obs[t]

    # Backward pass: carry obs_t · backward message of x_t, store the
    # backward message into x_{t-1}, in the rational form valid at w = 0:
    #   w_msg = A² w / (1 + Q w),  xi_msg = A xi / (1 + Q w).
    xi_bwd = torch.zeros_like(xi_obs)
    w_bwd = torch.zeros_like(w_obs)
    xi_b, w_b = xi_obs[T - 1], w_obs[T - 1]
    for t in range(T - 2, -1, -1):
        denom = 1.0 + Q * w_b
        xi_bwd[t] = A * xi_b / denom
        w_bwd[t] = A * A * w_b / denom
        xi_b = xi_bwd[t] + xi_obs[t]
        w_b = w_bwd[t] + w_obs[t]

    xi_m = xi_obs + xi_fwd + xi_bwd
    w_m = w_obs + w_fwd + w_bwd
    if prior is not None:
        xi_m[0] = xi_m[0] + pm / pv
        w_m[0] = w_m[0] + 1.0 / pv
    mean = (xi_m / w_m).movedim(0, -1).contiguous()
    variance = (1.0 / w_m).movedim(0, -1).contiguous()
    return ChainMarginals(mean, variance)


# -- Affine (matmul) formulation ---------------------------------------------
#
# The marginal precisions depend only on (A, Q, H, R, T) and the information
# means are linear in y, so the whole R-replica sweep is
#
#     mean = y @ S + c,     variance = v   (one data-independent row)
#
# with S the (T, T) impulse response of the smoother: one GEMM for the sweep.


@contextlib.contextmanager
def _full_float32_matmul():
    """Run float32 matrix products in full float32 (TF32 off) — the
    counterpart of ``Precision.HIGHEST`` — and restore the caller's setting."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


def lgssm_smoother_operator(
    T: int,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    prior: Optional[Prior] = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Precompute the affine smoother ``(S, c, v)``: ``mean = y @ S + c``,
    ``variance = v`` (shape ``(T,)``, data-independent), on ``device`` (the
    card unless the caller asks for another).

    Built by smoothing the T×T identity through :func:`lgssm_smooth_scan`,
    so it is exact for any (A, Q, H, R) and keeps the prior convention.
    """
    eye = torch.eye(T, dtype=dtype, device=device)
    base = lgssm_smooth_scan(torch.zeros(T, dtype=dtype, device=device), A, Q, H, R, prior)
    cols = lgssm_smooth_scan(eye, A, Q, H, R, prior)
    # cols.mean[s, t] = d mean_t / d y_s; base.mean is the prior-only offset.
    S = cols.mean - base.mean[None, :]
    return S, base.mean, base.variance


def lgssm_smooth_matmul(
    y: torch.Tensor,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    prior: Optional[Prior] = None,
    operator: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> ChainMarginals:
    """BP smoothing as ONE matrix product: ``mean = y @ S + c``.

    The same marginals as :func:`lgssm_smooth_scan` up to the product's
    rounding, in full float32.  Dense observations only: a NaN poisons its
    replica's outputs.  Pass ``operator`` (from
    :func:`lgssm_smoother_operator`) to build it once for many calls.  The
    variance is a broadcast view of one row.
    """
    if operator is None:
        operator = lgssm_smoother_operator(
            y.shape[-1], A, Q, H, R, prior, y.dtype, y.device
        )
    S, offset, var_row = operator
    with _full_float32_matmul():
        mean = torch.matmul(y, S.to(y.dtype)) + offset.to(y.dtype)
    variance = torch.broadcast_to(var_row.to(y.dtype), mean.shape)
    return ChainMarginals(mean, variance)


def lgssm_messages_scan(y, A=1.0, Q=1.0, H=1.0, R=1.0):
    """Return the observation and marginal messages in information form,
    ``{"obs": (xi, w), "marginal": (xi, w)}``, each of shape ``(..., T)``."""
    marg = lgssm_smooth_scan(y, A, Q, H, R)
    xi_obs, w_obs = _obs_message(y, H, R)
    return {
        "obs": (xi_obs, w_obs),
        "marginal": (marg.mean / marg.variance, 1.0 / marg.variance),
    }


# -- Time-parallel (associative scan) formulation ---------------------------
#
# Parallel Kalman filtering/smoothing (Särkkä & García-Fernández 2020,
# arXiv:1905.13002): filtering is an associative combination of per-step
# conditional-Gaussian elements (A, b, C, eta, J); smoothing of (E, g, L).


class _FilterElem(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _filter_combine(e1: _FilterElem, e2: _FilterElem) -> _FilterElem:
    """Scalar-state specialization of the paper's eq. (10)-(11)."""
    denom = 1.0 + e1.C * e2.J
    A = e2.A * e1.A / denom
    b = e2.A * (e1.b + e1.C * e2.eta) / denom + e2.b
    C = e2.A * e2.A * e1.C / denom + e2.C
    eta = e1.A * (e2.eta - e2.J * e1.b) / denom + e1.eta
    J = e1.A * e1.A * e2.J / denom + e1.J
    return _FilterElem(A, b, C, eta, J)


class _SmootherElem(NamedTuple):
    E: torch.Tensor
    g: torch.Tensor
    L: torch.Tensor


def _smoother_combine(e1: _SmootherElem, e2: _SmootherElem) -> _SmootherElem:
    """Reverse-direction combination (paper eq. (21)): elem1 closer to t=T."""
    return _SmootherElem(e2.E * e1.E, e2.E * e1.g + e2.g, e2.E * e2.E * e1.L + e2.L)


def _associative_scan(fn: Callable, elems: NamedTuple, reverse: bool = False):
    """Inclusive scan of ``fn`` over axis 0 of every field of ``elems``, in
    ``ceil(log2 T)`` Hillis–Steele rounds.

    ``fn(a, b)`` combines an earlier prefix ``a`` with a later element ``b``;
    with ``reverse`` the scan runs from the last step, as
    ``lax.associative_scan(..., reverse=True)`` does.
    """
    kind = type(elems)
    if reverse:
        elems = kind(*(e.flip(0) for e in elems))
    T = elems[0].shape[0]
    d = 1
    while d < T:
        combined = fn(kind(*(e[:-d] for e in elems)), kind(*(e[d:] for e in elems)))
        elems = kind(*(torch.cat([e[:d], c]) for e, c in zip(elems, combined)))
        d *= 2
    if reverse:
        elems = kind(*(e.flip(0) for e in elems))
    return elems


def lgssm_smooth_assoc(
    y: torch.Tensor,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    prior: Optional[Prior] = None,
) -> ChainMarginals:
    """Time-parallel BP smoothing over a log-depth associative scan.

    Same inputs and outputs as :func:`lgssm_smooth_scan`; O(log T) depth on
    the time axis.  Without a prior, ``y[..., 0]`` must be observed.
    """
    observed = ~torch.isnan(y)
    y = torch.where(observed, y, 0.0)
    obsT = observed.movedim(-1, 0)
    yT = y.movedim(-1, 0)  # (T, ...)
    batch_shape = yT.shape[1:]

    def batch(value):
        return torch.as_tensor(value, dtype=y.dtype, device=y.device).expand(batch_shape)

    # First filtering element: the filtered belief of x_1.  Without a prior
    # it is the first observation message alone (infinite prior variance).
    if prior is not None:
        m0, P0 = batch(prior[0]), batch(prior[1])
        S1 = H * P0 * H + R
        K1 = torch.where(obsT[0], P0 * H / S1, 0.0)
        b1 = m0 + K1 * (yT[0] - H * m0)
        C1 = P0 - K1 * H * P0
    else:
        b1 = yT[0] / H
        C1 = batch(R / (H * H))
    zeros = torch.zeros_like(b1)

    # Generic elements for t >= 2; a missing step's element is the pure
    # prediction (A, 0, Q, 0, 0).
    yrest, orest = yT[1:], obsT[1:]
    S = H * Q * H + R
    K = Q * H / S

    def pick(if_observed, if_missing):
        return torch.where(
            orest, yrest.new_tensor(if_observed), yrest.new_tensor(if_missing)
        )

    elems = _FilterElem(
        torch.cat([zeros[None], pick((1.0 - K * H) * A, A)]),
        torch.cat([b1[None], torch.where(orest, K * yrest, 0.0)]),
        torch.cat([C1[None], pick((1.0 - K * H) * Q, Q)]),
        torch.cat([zeros[None], torch.where(orest, A * H * yrest / S, 0.0)]),
        torch.cat([zeros[None], pick(A * H * H * A / S, 0.0)]),
    )
    filtered = _associative_scan(_filter_combine, elems)
    fm, fP = filtered.b, filtered.C  # filtered means/vars, shape (T, ...)

    # Smoothing elements for t < T:  E = C_f A / (A C_f A + Q);
    # g = m_f - E A m_f;  L = C_f - E A C_f.  The last is (0, m_f, C_f).
    Pp = A * A * fP[:-1] + Q
    E = fP[:-1] * A / Pp
    selems = _SmootherElem(
        torch.cat([E, torch.zeros_like(fm[:1])]),
        torch.cat([fm[:-1] - E * A * fm[:-1], fm[-1:]]),
        torch.cat([fP[:-1] - E * A * fP[:-1], fP[-1:]]),
    )
    smoothed = _associative_scan(_smoother_combine, selems, reverse=True)
    return ChainMarginals(
        smoothed.g.movedim(0, -1).contiguous(), smoothed.L.movedim(0, -1).contiguous()
    )
