"""Gradient-based and EM parameter learning, in PyTorch.

The counterpart of ``cortex_tpu/models/fit.py``: maximum likelihood of the
LGSSM by Adam through the Kalman filter or by EM with a closed-form M-step,
of the continuous HGF's volatility parameters by Adam through its filtering
recursion, and of the vector LGSSM's ``A``, ``Q`` and ``R`` by Adam through
its prediction-error log evidence.  ``optax.adam`` becomes ``torch.optim.Adam``
with the same learning rate, betas (0.9, 0.999) and eps 1e-8, and the JAX
``lax.scan`` over optimizer steps a Python loop.  Gradients flow through the
filters' loops over T; the HGF kernel has no backward, so the HGF fit runs
the scan.  Observations and initial parameters that are not tensors become
float32 tensors on the device of the tensors among them, or on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..ops.chains import scalar_kalman_update
from ..ops.chains_mv import mv_lgssm_log_evidence
from ..utils.tree import as_tensors, as_values
from .hgf import HGF

__all__ = [
    "LGSSMParams",
    "MvLGSSMParams",
    "fit_lgssm_ml",
    "fit_lgssm_em",
    "fit_hgf_ml",
    "fit_mv_lgssm_ml",
]

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class LGSSMParams(NamedTuple):
    """Unconstrained parameterization: ``A`` free, noise variances via log."""

    A: torch.Tensor
    log_Q: torch.Tensor
    log_R: torch.Tensor

    @property
    def Q(self) -> torch.Tensor:
        return torch.exp(*as_values(self.log_Q, like=self))

    @property
    def R(self) -> torch.Tensor:
        return torch.exp(*as_values(self.log_R, like=self))


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _inputs(y, init):
    """``y`` and the entries of ``init`` as the fits take them: arrays made
    tensors by :func:`~cortex_tpu_torch.utils.tree.as_tensors`, numbers made
    scalars of ``y``'s dtype and device."""
    y, *entries = as_tensors(y, *(init or ()))
    if init is None:
        return y, None
    return y, type(init)(*(e if isinstance(e, torch.Tensor) else _scalar(e, y)
                           for e in entries))


def _default_init(y: torch.Tensor) -> LGSSMParams:
    log_v = torch.log(torch.var(y, correction=0) / 2 + 1e-3)
    return LGSSMParams(_scalar(0.5, y), log_v, log_v.clone())


def _neg_log_evidence(params: LGSSMParams, y: torch.Tensor, prior) -> torch.Tensor:
    """Average negative log evidence over replicas (the prediction-error
    decomposition, with the parameters as differentiable inputs)."""
    A, Q, R = params.A, params.Q, params.R
    yT = y.movedim(-1, 0)
    m = _scalar(prior[0], y).expand(yT.shape[1:])
    v = _scalar(prior[1], y).expand(yT.shape[1:])
    lls = []
    for obs in yT:
        m_f, v_f, ll = scalar_kalman_update(obs, m, v, 1.0, R)
        m, v = A * m_f, A * A * v_f + Q
        lls.append(ll)
    return -torch.mean(torch.stack(lls).sum(0))


def _trace(values, like: torch.Tensor) -> torch.Tensor:
    """The scalars ``values`` as one tensor; shape (0,) when there are none,
    as JAX's scan gives it for zero steps."""
    if not values:
        return torch.zeros(0, dtype=like.dtype, device=like.device)
    return torch.stack(values)


def _adam(loss_fn, init: Sequence[torch.Tensor], n_steps: int, learning_rate: float):
    """Adam from ``init`` for ``n_steps``: the final parameters (detached)
    and the loss before each step, ``(n_steps,)``."""
    params = [p.detach().clone().requires_grad_(True) for p in init]
    opt = torch.optim.Adam(params, lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS)
    losses = []
    for _ in range(n_steps):
        opt.zero_grad()
        loss = loss_fn(*params)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return [p.detach() for p in params], _trace(losses, init[0])


def fit_lgssm_ml(
    y: torch.Tensor,
    n_steps: int = 500,
    learning_rate: float = 0.05,
    init: LGSSMParams = None,
    prior: Tuple[float, float] = (0.0, 10.0),
) -> Tuple[LGSSMParams, torch.Tensor]:
    """Maximum-likelihood LGSSM parameters by Adam on the exact log evidence.

    ``y``: ``(..., T)`` observations (replicas pooled into the likelihood).
    Returns the fitted params and the loss trace.
    """
    y, init = _inputs(y, init)
    init = _default_init(y) if init is None else init
    params, losses = _adam(
        lambda *p: _neg_log_evidence(LGSSMParams(*p), y, prior), init, n_steps, learning_rate
    )
    return LGSSMParams(*params), losses


def fit_lgssm_em(
    y: torch.Tensor,
    n_iters: int = 50,
    init: LGSSMParams = None,
    prior: Tuple[float, float] = (0.0, 10.0),
) -> Tuple[LGSSMParams, torch.Tensor]:
    """Maximum-likelihood LGSSM parameters (``A``, ``Q``, ``R``; ``H = 1``)
    by expectation-maximization with a closed-form M-step.

    The E-step is the RTS smoother plus the lag-one smoothed cross-covariance
    ``Cov(x_{t+1}, x_t | y) = G_t v^s_{t+1}`` (Shumway & Stoffer); the M-step
    pools sufficient statistics over replicas and time.  Returns ``(params,
    log_evidence_trace)``, where entry ``i`` is the pooled log evidence under
    the params entering iteration ``i`` (so it is non-decreasing).
    """
    y, init = _inputs(y, init)
    yT = y.movedim(-1, 0)  # (T, ...replicas)
    n_obs = yT.numel()
    n_trans = n_obs - yT[0].numel()
    pm = _scalar(prior[0], y).expand(yT.shape[1:])
    pv = _scalar(prior[1], y).expand(yT.shape[1:])
    params = _default_init(y) if init is None else init

    def e_step(A, Q, R):
        m, v = pm, pv  # predictive belief for this step
        m_fs, v_fs, lls = [], [], []
        for obs in yT:
            m_f, v_f, ll = scalar_kalman_update(obs, m, v, 1.0, R)
            m, v = A * m_f, A * A * v_f + Q
            m_fs.append(m_f)
            v_fs.append(v_f)
            lls.append(ll)
        m_s, v_s, cs = [m_fs[-1]], [v_fs[-1]], []
        for m_f, v_f in zip(reversed(m_fs[:-1]), reversed(v_fs[:-1])):
            m_next, v_next = m_s[-1], v_s[-1]
            v_pred = A * A * v_f + Q
            G = v_f * A / v_pred
            m_s.append(m_f + G * (m_next - A * m_f))
            v_s.append(v_f + G * G * (v_next - v_pred))
            cs.append(G * v_next)
        m_s = torch.stack(m_s[::-1])
        v_s = torch.stack(v_s[::-1])
        return m_s, v_s, torch.stack(cs[::-1]), torch.sum(torch.stack(lls))

    lls = []
    for _ in range(n_iters):
        m_s, v_s, cs, ll = e_step(params.A, params.Q, params.R)
        ex2 = v_s + m_s**2
        s11 = torch.sum(ex2[:-1])
        s00 = torch.sum(ex2[1:])
        s10 = torch.sum(cs + m_s[1:] * m_s[:-1])
        A_new = s10 / s11
        Q_new = (s00 - 2.0 * A_new * s10 + A_new**2 * s11) / n_trans
        R_new = torch.sum((yT - m_s) ** 2 + v_s) / n_obs
        params = LGSSMParams(A_new, torch.log(Q_new), torch.log(R_new))
        lls.append(ll)
    return params, _trace(lls, y)


def fit_hgf_ml(
    u: torch.Tensor,
    n_steps: int = 300,
    learning_rate: float = 0.05,
    init_omega: float = -2.0,
    init_log_theta: float = -3.0,
    kappa: float = 1.0,
    pi_u: float = 10.0,
):
    """Fit the continuous HGF's volatility parameters (ω, θ) by maximizing
    the one-step-ahead predictive likelihood, by Adam through the filtering
    scan.  Returns ``((omega, theta), losses)``."""
    u, = as_tensors(u)

    def nll(omega, log_theta):
        model = HGF(kappa=kappa, omega=omega, theta=torch.exp(log_theta), pi_u=pi_u)
        return -torch.mean(model.log_likelihood(u))

    init = (_scalar(init_omega, u), _scalar(init_log_theta, u))
    (omega, log_theta), losses = _adam(nll, init, n_steps, learning_rate)
    return (omega, torch.exp(log_theta)), losses


class MvLGSSMParams(NamedTuple):
    """Unconstrained vector-model parameterization: ``A`` free; ``Q``/``R``
    through Cholesky factors with a log diagonal and a free lower part, so
    the noise covariances stay PD throughout optimization."""

    A: torch.Tensor  # (d, d)
    q_chol: torch.Tensor  # (d, d) lower, log-diagonal
    r_chol: torch.Tensor  # (m, m) lower, log-diagonal

    @staticmethod
    def _expand(chol_param: torch.Tensor) -> torch.Tensor:
        L = torch.tril(chol_param, diagonal=-1) + torch.diag(torch.exp(torch.diagonal(chol_param)))
        return L @ L.T

    @property
    def Q(self) -> torch.Tensor:
        return self._expand(*as_values(self.q_chol, like=self))

    @property
    def R(self) -> torch.Tensor:
        return self._expand(*as_values(self.r_chol, like=self))


def fit_mv_lgssm_ml(
    y: torch.Tensor,
    H,
    d: int,
    n_steps: int = 300,
    learning_rate: float = 0.02,
    init: "MvLGSSMParams | None" = None,
) -> Tuple[MvLGSSMParams, torch.Tensor]:
    """ML system identification for the vector LGSSM with known ``H``:
    Adam on the prediction-error log evidence
    (:func:`cortex_tpu_torch.ops.chains_mv.mv_lgssm_log_evidence`), pooled
    over the replica series of ``y`` ``(..., T, m)``, on its device.  Returns
    the fitted unconstrained params and the loss trace ``(n_steps,)``; read
    ``params.A/Q/R`` for the constrained matrices."""
    y, H, *entries = as_tensors(y, H, *(init or ()))
    init = MvLGSSMParams(*entries) if entries else None
    opts = dict(dtype=y.dtype, device=y.device)
    H = torch.as_tensor(H, **opts)
    if init is None:
        m = H.shape[0]
        init = MvLGSSMParams(0.5 * torch.eye(d, **opts), torch.zeros((d, d), **opts),
                             torch.zeros((m, m), **opts))
    prior = (torch.zeros((d,), **opts), 10.0 * torch.eye(d, **opts))

    def nll(*p):
        params = MvLGSSMParams(*p)
        return -torch.mean(mv_lgssm_log_evidence(y, params.A, params.Q, H, params.R, prior))

    params, losses = _adam(nll, init, n_steps, learning_rate)
    return MvLGSSMParams(*params), losses
