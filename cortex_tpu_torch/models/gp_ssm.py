"""State-space (Markovian) Gaussian processes: Matérn GPs as Kalman sweeps, in PyTorch.

The counterpart of ``cortex_tpu/models/gp_ssm.py``.  A 1-D-input GP with a
Matérn kernel is exactly a linear SDE observed at the input locations
(Hartikainen & Särkkä 2010), so exact GP regression lowers to Kalman
filtering and RTS smoothing: O(n) work with a state of 1–3 dimensions.
The transition matrices are closed-form (no ``expm``), one a gap, so
irregular sampling is free.  The sweeps are Python loops over time (one
series, a few small launches a step: host-bound on a card).  The log
marginal likelihood is differentiable in the hyperparameters;
:func:`fit_gpssm_ml` runs Adam on it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..dists.gaussian import _device, _spd_solve_logdet
from ..utils.tree import as_float32_tensor
from .fit import _adam

__all__ = ["GPSSM", "GPSSMPosterior", "fit_gpssm_ml", "matern_state_space"]


def matern_state_space(kernel: str, lengthscale, variance, dts):
    """Per-step transition matrices for a Matérn SDE on gaps ``dts`` (T,).

    Returns ``(A, Q, H, P_inf)`` with ``A, Q: (T, d, d)``, ``H: (d,)``,
    ``P_inf: (d, d)`` — all analytic (``A = expm(F dt)`` in closed form;
    ``Q = P_inf − A P_inf Aᵀ`` by stationarity).
    """
    dts = as_float32_tensor(dts, _device(dts))
    ell = torch.as_tensor(lengthscale, dtype=dts.dtype, device=dts.device)
    var = torch.as_tensor(variance, dtype=dts.dtype, device=dts.device)
    zero = torch.zeros((), dtype=dts.dtype, device=dts.device)

    def matrix(rows):
        return torch.stack([torch.stack(list(r), dim=-1) for r in rows], dim=-2)

    if kernel == "matern12":
        lam = 1.0 / ell
        A = torch.exp(-lam * dts)[:, None, None]
        P_inf = var.reshape(1, 1)
        H = torch.ones((1,), dtype=dts.dtype, device=dts.device)
    elif kernel == "matern32":
        lam = math.sqrt(3.0) / ell
        e = torch.exp(-lam * dts)
        # expm of [[0,1],[-λ²,-2λ]] dt (defective eigenvalue -λ, analytic):
        A = e[:, None, None] * matrix([(1.0 + lam * dts, dts),
                                        (-(lam**2) * dts, 1.0 - lam * dts)])
        P_inf = matrix([(var, zero), (zero, var * lam**2)])
        H = torch.tensor([1.0, 0.0], dtype=dts.dtype, device=dts.device)
    elif kernel == "matern52":
        lam = math.sqrt(5.0) / ell
        e = torch.exp(-lam * dts)
        t = dts
        # expm of the companion form of (d/dt + λ)³ — triple eigenvalue -λ:
        # expm(F t) = e^{-λt} [ I + (F+λI) t + (F+λI)² t²/2 ]
        A = e[:, None, None] * matrix([
            (1.0 + lam * t + 0.5 * lam**2 * t**2, t + lam * t**2, 0.5 * t**2),
            (-0.5 * lam**3 * t**2, 1.0 + lam * t - lam**2 * t**2, t - 0.5 * lam * t**2),
            (0.5 * lam**4 * t**2 - lam**3 * t, lam**3 * t**2 - 3.0 * lam**2 * t,
             1.0 - 2.0 * lam * t + 0.5 * lam**2 * t**2),
        ])
        kappa = lam**2 / 3.0
        one = torch.ones((), dtype=dts.dtype, device=dts.device)
        P_inf = var * matrix([(one, zero, -kappa), (zero, kappa, zero), (-kappa, zero, lam**4)])
        H = torch.tensor([1.0, 0.0, 0.0], dtype=dts.dtype, device=dts.device)
    else:
        raise ValueError(f"unknown Markovian kernel {kernel!r}")

    Q = P_inf[None] - A @ P_inf[None] @ A.mT
    # Symmetrize against float roundoff (Q must stay PSD for the filter).
    Q = 0.5 * (Q + Q.mT)
    return A, Q, H, P_inf


class GPSSMPosterior(NamedTuple):
    mean: torch.Tensor  # (T,) posterior mean of f at the inputs
    variance: torch.Tensor  # (T,) posterior variance of f
    log_marginal_likelihood: torch.Tensor  # ()


def _check_sorted(t: torch.Tensor, what: str) -> None:
    if bool(torch.any(torch.diff(t) < 0)):
        raise ValueError(what)


@dataclasses.dataclass(frozen=True)
class GPSSM:
    """Markovian GP regression: ``f ~ GP(0, k)``, ``y = f(t) + N(0, noise)``.

    ``kernel`` ∈ {"matern12", "matern32", "matern52"}.  Inputs ``t`` must be
    sorted ascending (1-D inputs only — that is what makes the GP a chain).
    """

    kernel: str = "matern32"
    lengthscale: float = 1.0
    variance: float = 1.0
    noise: float = 0.1

    def posterior(self, t, y) -> GPSSMPosterior:
        """Exact GP posterior at the training inputs + log evidence,
        via Kalman filter + RTS smoother over the Matérn SDE."""
        dev = _device(t, y)
        t, y = as_float32_tensor(t, dev), as_float32_tensor(y, dev)
        _check_sorted(t, "GPSSM inputs t must be sorted ascending: negative gaps make "
                         "exp(-λ·dt) blow up and the chain filter silently wrong.")
        A, Q, H, P_inf = matern_state_space(self.kernel, self.lengthscale, self.variance,
                                            torch.diff(t))
        d = H.shape[0]
        noise = torch.as_tensor(self.noise, dtype=t.dtype, device=dev)

        def kalman_update(m_pred, P_pred, obs):
            PH = P_pred @ H
            s = H @ PH + noise
            k = PH / s
            innov = obs - H @ m_pred
            P = P_pred - torch.outer(k, PH)
            ll = -0.5 * (torch.log(2.0 * math.pi * s) + innov**2 / s)
            return m_pred + k * innov, 0.5 * (P + P.T), ll

        m, P, lml = kalman_update(torch.zeros((d,), dtype=t.dtype, device=dev), P_inf, y[0])
        ms, Ps, mps, Pps = [m], [P], [], []
        for i in range(1, y.shape[0]):
            m_pred = A[i - 1] @ m
            P_pred = A[i - 1] @ P @ A[i - 1].T + Q[i - 1]
            m, P, ll = kalman_update(m_pred, P_pred, y[i])
            lml = lml + ll
            ms.append(m)
            Ps.append(P)
            mps.append(m_pred)
            Pps.append(P_pred)

        # RTS backward: G_t = P_t A_{t+1}ᵀ P_pred_{t+1}⁻¹.
        m_s, P_s = ms[-1], Ps[-1]
        sms, sPs = [m_s], [P_s]
        for i in range(len(ms) - 2, -1, -1):
            G = _spd_solve_logdet(Pps[i], (Ps[i] @ A[i].T).T)[0].T
            m_s = ms[i] + G @ (m_s - mps[i])
            P_s = Ps[i] + G @ (P_s - Pps[i]) @ G.T
            P_s = 0.5 * (P_s + P_s.T)
            sms.append(m_s)
            sPs.append(P_s)
        sm = torch.stack(sms[::-1])
        sP = torch.stack(sPs[::-1])
        return GPSSMPosterior(sm @ H, torch.einsum("i,tij,j->t", H, sP, H), lml)

    def log_marginal_likelihood(self, t, y) -> torch.Tensor:
        return self.posterior(t, y).log_marginal_likelihood


def fit_gpssm_ml(
    t,
    y,
    kernel: str = "matern32",
    n_iters: int = 200,
    learning_rate: float = 0.05,
    init: Optional[Tuple[float, float, float]] = None,
) -> Tuple[GPSSM, torch.Tensor]:
    """ML-II hyperparameters by Adam on the O(n) negative log evidence.

    Returns the fitted model and the per-iteration NLL trace.
    """
    dev = _device(t, y)
    t, y = as_float32_tensor(t, dev), as_float32_tensor(y, dev)
    _check_sorted(t, "fit_gpssm_ml requires t sorted ascending")
    if init is None:
        span = (t[-1] - t[0]) / max(t.shape[0] - 1, 1)
        v = float(torch.var(y, correction=0))
        init = (float(span * 10.0), v, v * 0.1)
    params0 = torch.log(torch.tensor(init, dtype=t.dtype, device=dev))

    def nll(log_params):
        ell, var, noise = torch.exp(log_params)
        return -GPSSM(kernel, ell, var, noise).log_marginal_likelihood(t, y)

    (params,), losses = _adam(nll, [params0], n_iters, learning_rate)
    ell, var, noise = (float(v) for v in torch.exp(params))
    return GPSSM(kernel=kernel, lengthscale=ell, variance=var, noise=noise), losses
