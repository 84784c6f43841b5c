"""Square-root Kalman filtering/smoothing — QR-factored covariance propagation, in PyTorch.

The counterpart of ``cortex_tpu/ops/sqrt_kalman.py``.  The standard
covariance recursions (:mod:`cortex_tpu_torch.ops.chains_mv`) subtract
nearly-equal matrices (``P - K S Kᵀ``), which in float32 can lose
positive-definiteness on ill-conditioned chains.  The square-root ("array")
algorithm propagates a triangular factor ``S`` with ``P = S Sᵀ`` through
orthogonal transformations — every step is a QR factorization of a stacked
pre-array — so the covariance is PSD by construction.  The sweeps are
Python loops over time, batched over replicas, on the device of ``y``.

References: Kailath, Sayed & Hassibi, *Linear Estimation*, ch. 12 (array
algorithms); Särkkä, *Bayesian Filtering and Smoothing*, §6.3.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..dists.gaussian import _cholesky_nan
from .chains_mv import MvChainMarginals, _like, _mT, _observations

__all__ = ["SqrtFilterBeliefs", "sqrt_lgssm_filter", "sqrt_lgssm_smooth"]


def _tria(stacked: torch.Tensor) -> torch.Tensor:
    """Lower-triangular factor of ``stackedᵀ @ stacked`` by thin QR.

    ``stacked``: ``(..., k, d)`` pre-array whose Gram matrix is the target
    covariance.  Returns ``(..., d, d)`` lower triangular ``S`` with
    ``S Sᵀ = stackedᵀ stacked``, sign-normalized to a non-negative diagonal
    (QR's R has arbitrary row signs).
    """
    r = torch.linalg.qr(stacked, mode="r").R  # (..., d, d) upper
    sign = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, 1.0, sign)
    return _mT(r * sign[..., :, None])


class SqrtFilterBeliefs(NamedTuple):
    """Filtered beliefs in square-root form.

    ``mean``: ``(..., T, d)``; ``chol``: ``(..., T, d, d)`` lower-triangular
    factors of the filtered covariances (``P = chol @ cholᵀ``).
    """

    mean: torch.Tensor
    chol: torch.Tensor


def _prepare(y, A, Q, H, R, prior):
    y = _observations(y, A, Q, H, R, prior)
    A, Q, H, R, m0, P0 = _like(y, A, Q, H, R, *prior)
    Lq, Lr, L0 = _cholesky_nan(Q), _cholesky_nan(R), _cholesky_nan(P0)
    # Missing steps (any NaN in the observation vector) skip the measurement
    # update — the same whole-step convention as the shared chain elements.
    observed = ~torch.any(torch.isnan(y), dim=-1)  # (..., T)
    y = torch.where(observed[..., None], y, 0.0)
    return y.movedim(-2, 0), observed.movedim(-1, 0), A, H, Lq, Lr, m0, L0


def sqrt_lgssm_filter(
    y: torch.Tensor,
    A,
    Q,
    H,
    R,
    prior: Tuple[object, object],
) -> SqrtFilterBeliefs:
    """Square-root Kalman filter.

    Parameters mirror :func:`cortex_tpu_torch.ops.chains_mv.mv_lgssm_smooth`:
    ``y`` is ``(..., T, m)``, ``A``/``Q`` are ``(d, d)``, ``H`` is ``(m, d)``,
    ``R`` is ``(m, m)``, ``prior = (m0, P0)``.  Never forms a full
    covariance: predict and update are each one QR of a stacked pre-array.
    """
    yT, obsT, A, H, Lq, Lr, m0, L0 = _prepare(y, A, Q, H, R, prior)
    batch = tuple(yT.shape[1:-1])
    d = A.shape[-1]
    m = H.shape[-2]

    def measurement(mean, S, obs, mask):
        # U = [[Lrᵀ, 0], [Sᵀ Hᵀ, Sᵀ]]  ⇒  UᵀU = [[R + H P Hᵀ, H P], [P Hᵀ, P]]
        lead = tuple(S.shape[:-2])
        top = torch.cat(
            [_mT(Lr).expand(lead + (m, m)), torch.zeros(lead + (m, d), dtype=S.dtype,
                                                         device=S.device)],
            dim=-1,
        )
        bot = torch.cat([_mT(S) @ _mT(H).expand(lead + (d, m)), _mT(S)], dim=-1)
        post = _tria(torch.cat([top, bot], dim=-2))  # (..., m+d, m+d)
        Sy = post[..., :m, :m]  # chol of innovation cov
        Kbar = post[..., m:, :m]  # K @ Sy
        S_f = post[..., m:, m:]  # chol of filtered cov
        innov = obs - torch.einsum("md,...d->...m", H, mean)
        # K (y − H m) = Kbar Sy⁻¹ innov
        u = torch.linalg.solve_triangular(Sy, innov[..., None], upper=False)
        mean_f = mean + (Kbar @ u)[..., 0]
        return (
            torch.where(mask[..., None], mean_f, mean),
            torch.where(mask[..., None, None], S_f, S),
        )

    def predict(mean, S):
        lead = tuple(S.shape[:-2])
        stacked = torch.cat(
            [_mT(S) @ _mT(A).expand(lead + (d, d)), _mT(Lq).expand(lead + (d, d))], dim=-2
        )  # (..., 2d, d); Gram = A P Aᵀ + Q
        return torch.einsum("ij,...j->...i", A, mean), _tria(stacked)

    mean, S = measurement(m0.expand(batch + (d,)), L0.expand(batch + (d, d)), yT[0], obsT[0])
    means, chols = [mean], [S]
    for obs, mask in zip(yT[1:], obsT[1:]):
        mean, S = measurement(*predict(mean, S), obs, mask)
        means.append(mean)
        chols.append(S)
    return SqrtFilterBeliefs(
        torch.stack(means).movedim(0, -2).contiguous(),
        torch.stack(chols).movedim(0, -3).contiguous(),
    )


def sqrt_lgssm_smooth(
    y: torch.Tensor,
    A,
    Q,
    H,
    R,
    prior: Tuple[object, object],
) -> MvChainMarginals:
    """Square-root RTS smoother: the sqrt filter forward and a
    sqrt-propagated backward pass.

    The smoothed covariance recursion ``P_s = P_f + G (P_s' − P_p) Gᵀ`` is
    computed in factored form through the Joseph-style identity
    ``P_f − G P_p Gᵀ = (I − G A) P_f (I − G A)ᵀ + G Q Gᵀ``, so the backward
    step is one QR of a ``(3d, d)`` pre-array — PSD by construction.  Returns
    full covariances (the contract of
    :func:`cortex_tpu_torch.ops.chains_mv.mv_lgssm_smooth`).
    """
    beliefs = sqrt_lgssm_filter(y, A, Q, H, R, prior)
    _, _, A, H, Lq, _, _, _ = _prepare(y, A, Q, H, R, prior)
    d = A.shape[-1]
    fm = beliefs.mean.movedim(-2, 0)  # (T, ..., d)
    fS = beliefs.chol.movedim(-3, 0)  # (T, ..., d, d)
    I = torch.eye(d, dtype=A.dtype, device=A.device)

    ms, Ss = fm[-1], fS[-1]  # smoothed at t+1 (mean, chol)
    means, chols = [ms], [Ss]
    for t in range(fm.shape[0] - 2, -1, -1):
        mf, Sf = fm[t], fS[t]  # filtered at t
        Pf = Sf @ _mT(Sf)
        # Predicted sqrt at t+1 from the filtered factor (one QR).
        Sp = _tria(torch.cat([_mT(Sf) @ _mT(A).expand(Sf.shape), _mT(Lq).expand(Sf.shape)],
                             dim=-2))
        # Gain G = P_f Aᵀ P_p⁻¹ by two triangular solves against Sp.
        t1 = torch.linalg.solve_triangular(Sp, A @ Pf, upper=False)
        G = _mT(torch.linalg.solve_triangular(_mT(Sp), t1, upper=True))
        ms = mf + torch.einsum(
            "...ij,...j->...i", G, ms - torch.einsum("ij,...j->...i", A, mf))
        IGA = I.expand(G.shape) - G @ A
        stacked = torch.cat(
            [_mT(Sf) @ _mT(IGA), _mT(Lq).expand(G.shape) @ _mT(G), _mT(Ss) @ _mT(G)], dim=-2
        )  # (..., 3d, d)
        Ss = _tria(stacked)
        means.append(ms)
        chols.append(Ss)
    means = torch.stack(means[::-1])
    chols = torch.stack(chols[::-1])
    covs = chols @ _mT(chols)
    return MvChainMarginals(means.movedim(0, -2).contiguous(), covs.movedim(0, -3).contiguous())
