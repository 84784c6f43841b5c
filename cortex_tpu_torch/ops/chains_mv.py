"""Vector-state LGSSM smoothing, in PyTorch: sequential, blocked and time-parallel.

The counterpart of ``cortex_tpu/ops/chains_mv.py``, for d-dimensional
states and m-dimensional observations:

    x_t = A x_{t-1} + N(0, Q),    y_t = H x_t + N(0, R)

with the parallel Kalman filter/smoother elements of Särkkä &
García-Fernández (2020) and matrix combines.  The same functions, arguments
and results as the JAX package's, written as eager tensor code on the
device of ``y``: a ``lax.scan`` is a Python loop (every replica at once),
``lax.associative_scan`` is the port's Hillis–Steele scan
(:func:`cortex_tpu_torch.ops.chains._associative_scan`), whose combine tree
differs from XLA's, so the time-parallel paths agree with JAX to rounding.

The small solves are JAX's unrolled Gauss–Jordan eliminations, with the
same pivoting and arithmetic (:func:`_solve_small`,
:func:`_solve_small_logdet`); above d = 32 they call the library solvers.
The lane-major helpers keep JAX's layout and contracts, with the replica
axis last (``(..., d, d, R)``), so the blocked smoother and the time-sharded
smoother share them.  Model parameters are taken in the dtype and on the
device of ``y``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..dists.gaussian import _cholesky_nan
from ..utils.tree import as_float32_tensor, input_device, to_tensor, tree_leaves
from .chains import _associative_scan, _full_float32_matmul

__all__ = [
    "MvChainMarginals",
    "MvSmootherOperator",
    "mv_lgssm_filter",
    "mv_lgssm_log_evidence",
    "mv_lgssm_smooth",
    "mv_lgssm_smooth_blocked",
    "mv_lgssm_smooth_seq",
    "mv_lgssm_smooth_matmul",
    "mv_lgssm_smoother_operator",
]


class MvChainMarginals(NamedTuple):
    mean: torch.Tensor  # (..., T, d)
    cov: torch.Tensor  # (..., T, d, d)


class _Elem(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


class _SElem(NamedTuple):
    E: torch.Tensor
    g: torch.Tensor
    L: torch.Tensor


def _observations(y, *params) -> torch.Tensor:
    """``y`` as the chains take it: a tensor as given; an array as float32 on
    the device of the first tensor among ``y`` and ``params`` (tuples
    included), or on the card."""
    return as_float32_tensor(y, input_device(y, *tree_leaves(params)))


def _like(y: torch.Tensor, *arrays):
    """``arrays`` as tensors in the dtype and on the device of ``y``."""
    return tuple(to_tensor(a, dtype=y.dtype, device=y.device) for a in arrays)


def _map(fn, *elems):
    """``fn`` over the fields of one or more element tuples of one kind."""
    kind = type(elems[0])
    return kind(*(fn(*fields) for fields in zip(*elems)))


def _mT(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _eye(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _solve_small(M: torch.Tensor, B: torch.Tensor, pivot: bool = True) -> torch.Tensor:
    """Batched ``solve(M, B)`` for small static ``d`` by unrolled
    Gauss–Jordan elimination, as the JAX package computes it; above d = 32,
    ``torch.linalg.solve``.

    ``pivot=False`` drops the partial-pivoting row swaps.  Only valid when
    every leading principal pivot is structurally nonzero — true for the
    smoother's systems: ``M = I + C @ J`` with C, J PSD has eigenvalues
    ≥ 1, and predicted covariances are SPD.  The general default pivots."""
    d = M.shape[-1]
    if d > 32:
        return torch.linalg.solve(M, B)
    aug = torch.cat([M, B], dim=-1)  # (..., d, d+k)
    idx = torch.arange(d, device=M.device)
    for i in range(d):
        if pivot:
            col = torch.abs(aug[..., :, i])
            col = torch.where(idx >= i, col, -torch.inf)  # among rows >= i
            p = torch.argmax(col, dim=-1)[..., None]  # (..., 1)
            perm = torch.where(idx == i, p, torch.where(idx == p, i, idx))
            aug = torch.take_along_dim(aug, perm[..., :, None], dim=-2)
        piv_row = aug[..., i : i + 1, :]
        piv_row = piv_row / piv_row[..., :, i : i + 1]
        factors = aug[..., :, i : i + 1]
        is_i = (idx == i)[:, None]
        aug = torch.where(is_i, piv_row, aug - factors * piv_row)
    return aug[..., :, d:]


def _solve_small_logdet(M: torch.Tensor, B: torch.Tensor):
    """Pivotless :func:`_solve_small` that also returns ``log |det M|``
    (the running product of elimination pivots): the Kalman update needs
    ``S⁻¹`` systems and ``log det S`` for the evidence, and gets both from
    one elimination.  Requires the nonzero-pivot condition of
    ``pivot=False`` (S is SPD).  Above d = 32, a Cholesky solve
    (``log det = 2 Σ log diag(L)``)."""
    d = M.shape[-1]
    if d > 32:
        L = _cholesky_nan(M)
        sol = torch.cholesky_solve(B, L)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        return sol, logdet
    aug = torch.cat([M, B], dim=-1)
    idx = torch.arange(d, device=M.device)
    logdet = torch.zeros(M.shape[:-2], dtype=M.dtype, device=M.device)
    for i in range(d):
        piv = aug[..., i, i]
        logdet = logdet + torch.log(torch.abs(piv))
        piv_row = aug[..., i : i + 1, :] / piv[..., None, None]
        factors = aug[..., :, i : i + 1]
        is_i = (idx == i)[:, None]
        aug = torch.where(is_i, piv_row, aug - factors * piv_row)
    return aug[..., :, d:], logdet


def _combine(e1: _Elem, e2: _Elem) -> _Elem:
    """Matrix filtering combine (Särkkä 2020 eq. 10); e1 earlier, e2 later.
    ``M = I + C @ J`` with C, J PSD is nonsingular; the pivotless
    elimination further needs C SPD, which the filtered and predicted
    covariances are by construction."""
    d = e1.A.shape[-1]
    I = _eye(d, e1.A)
    M = I + e1.C @ e2.J  # (..., d, d)
    # One shared elimination for the three M-systems (stack on the k axis).
    rhs = torch.cat(
        [e1.A, (e1.b + (e1.C @ e2.eta[..., None])[..., 0])[..., None], e1.C], dim=-1
    )
    sol = _solve_small(M, rhs, pivot=False)
    MA, Mb, MC = sol[..., :d], sol[..., d : d + 1], sol[..., d + 1 :]
    A = e2.A @ MA
    b = (e2.A @ Mb)[..., 0] + e2.b
    C = e2.A @ MC @ _mT(e2.A) + e2.C
    Mt = I + e2.J @ e1.C
    rhs_t = torch.cat([(e2.eta - (e2.J @ e1.b[..., None])[..., 0])[..., None], e2.J], dim=-1)
    sol_t = _solve_small(Mt, rhs_t, pivot=False)
    eta = (_mT(e1.A) @ sol_t[..., :1])[..., 0] + e1.eta
    J = _mT(e1.A) @ sol_t[..., 1:] @ e1.A + e1.J
    return _Elem(A, b, C, eta, J)


def _scombine(e1: _SElem, e2: _SElem) -> _SElem:
    """Smoother combine, reverse direction; e1 later (closer to T), e2
    earlier."""
    return _SElem(
        e2.E @ e1.E,
        (e2.E @ e1.g[..., None])[..., 0] + e2.g,
        e2.E @ e1.L @ _mT(e2.E) + e2.L,
    )


def _prepend(elem1, rest):
    """Element 1 (no time axis) before the elements of steps 2..T."""
    return _map(lambda a, r: torch.cat([a[None], r], dim=0), elem1, rest)


def _build_filter_elems_component(y, A, Q, H, R, m0, P0) -> _Elem:
    """Per-step filter elements under per-component missingness: every step
    gets its own masked observation model ``H'_t = diag(c_t) H``,
    ``R'_t = diag(c_t) R diag(c_t) + diag(1-c_t)`` (the embedding of
    :func:`_mv_filter_scan`), so the innovation system is solved per step.
    A fully-observed step reproduces the shared element exactly; a
    fully-missing step degenerates to pure prediction ``(A, 0, Q, 0, 0)``."""
    d = A.shape[-1]
    mdim = H.shape[-2]
    cmask = ~torch.isnan(y)  # (..., T, m)
    y = torch.where(cmask, y, 0.0)
    yT = y.movedim(-2, 0)  # (T, ..., m)
    cT = cmask.movedim(-2, 0).to(y.dtype)  # (T, ..., m)
    batch = tuple(yT.shape[1:-1])
    I = _eye(d, y)
    eye_m = _eye(mdim, y)

    def masked_obs(c):
        Hm = c[..., :, None] * H
        Rm = c[..., :, None] * c[..., None, :] * R + (1.0 - c)[..., :, None] * eye_m
        return Hm, Rm

    # Elements t >= 2: predict with (A, Q), update with the masked model.
    Hm, Rm = masked_obs(cT[1:])  # (T-1, ..., m, ·)
    S = Hm @ Q @ _mT(Hm) + Rm
    K = _mT(_solve_small(_mT(S), Hm @ _mT(Q), pivot=False))  # Q H'ᵀ S⁻¹
    IKH = I - K @ Hm
    HtSi = _mT(_solve_small(_mT(S), Hm, pivot=False))  # H'ᵀ S⁻¹
    AtHtSi = _mT(A) @ HtSi  # (T-1, ..., d, m)
    elems_rest = _Elem(
        IKH @ A,
        torch.einsum("t...dm,t...m->t...d", K, yT[1:]),
        IKH @ Q,
        torch.einsum("t...dm,t...m->t...d", AtHtSi, yT[1:]),
        AtHtSi @ Hm @ A,
    )

    # First element: filtered belief of x_1 under the prior.
    Hm1, Rm1 = masked_obs(cT[0])
    S1 = Hm1 @ P0 @ _mT(Hm1) + Rm1
    K1 = _mT(_solve_small(_mT(S1), Hm1 @ _mT(P0), pivot=False))
    b1 = m0 + torch.einsum(
        "...dm,...m->...d", K1, yT[0] - torch.einsum("...md,d->...m", Hm1, m0)
    )
    C1 = (I - K1 @ Hm1) @ P0
    zeros_d = torch.zeros(batch + (d,), dtype=y.dtype, device=y.device)
    zeros_dd = torch.zeros(batch + (d, d), dtype=y.dtype, device=y.device)
    elem1 = _Elem(zeros_dd, b1.expand(batch + (d,)), C1.expand(batch + (d, d)), zeros_d, zeros_dd)
    return _prepend(elem1, elems_rest)


def _build_filter_elems(y, A, Q, H, R, m0, P0, component_missing=False) -> _Elem:
    """Per-step parallel-filter elements, time-major ``(T, ..., ·)``.

    Element t composes the predict+update map of step t; element 1 is the
    prior-conditioned filtered belief of x₁ (A = 0).  Time steps whose
    observation vector contains any NaN degenerate to the pure prediction
    element (A, 0, Q, 0, 0); ``component_missing=True`` handles dense
    per-component gaps (:func:`_build_filter_elems_component`)."""
    if component_missing:
        return _build_filter_elems_component(y, A, Q, H, R, m0, P0)
    d = A.shape[-1]
    observed = ~torch.any(torch.isnan(y), dim=-1)  # (..., T)
    y = torch.where(observed[..., None], y, 0.0)
    obsT = observed.movedim(-1, 0)  # (T, ...)
    yT = y.movedim(-2, 0)  # (T, ..., m)
    batch = tuple(yT.shape[1:-1])
    I = _eye(d, y)

    # Generic elements (t >= 2); identical for all steps except the data term.
    S = H @ Q @ _mT(H) + R  # (m, m)
    K = _mT(_solve_small(_mT(S), H @ _mT(Q), pivot=False))  # Q Hᵀ S⁻¹, (d, m)
    IKH = I - K @ H
    HtSi = _mT(_solve_small(_mT(S), H, pivot=False))  # Hᵀ S⁻¹, (d, m)
    eta_coef = _mT(A) @ HtSi  # (d, m)
    J_g = _mT(A) @ HtSi @ H @ A  # (d, d)
    b_g = torch.einsum("dm,t...m->t...d", K, yT[1:])
    eta_g = torch.einsum("dm,t...m->t...d", eta_coef, yT[1:])

    mrest = obsT[1:][..., None, None]  # (T-1, ..., 1, 1)
    elems_rest = _Elem(
        torch.where(mrest, IKH @ A, A),
        torch.where(mrest[..., 0], b_g, 0.0),
        torch.where(mrest, IKH @ Q, Q),
        torch.where(mrest[..., 0], eta_g, 0.0),
        torch.where(mrest, J_g, 0.0),
    )

    # First element: filtered belief of x_1 under the prior (prior alone if
    # the first observation is missing).
    S1 = H @ P0 @ _mT(H) + R
    K1 = _mT(_solve_small(_mT(S1), H @ _mT(P0), pivot=False))  # P0 Hᵀ S1⁻¹
    m1 = obsT[0][..., None, None]
    b1 = m0 + torch.where(
        m1[..., 0], torch.einsum("dm,...m->...d", K1, yT[0] - H @ m0), 0.0
    )
    C1 = torch.where(m1, (I - K1 @ H) @ P0, P0)
    zeros_d = torch.zeros(batch + (d,), dtype=y.dtype, device=y.device)
    zeros_dd = torch.zeros(batch + (d, d), dtype=y.dtype, device=y.device)
    elem1 = _Elem(zeros_dd, b1.expand(batch + (d,)), C1.expand(batch + (d, d)), zeros_d, zeros_dd)
    return _prepend(elem1, elems_rest)


def _build_smoother_elems(fm, fP, A, Q) -> _SElem:
    """Backward (RTS) affine elements from time-major filtered moments
    ``fm (T, ..., d)``, ``fP (T, ..., d, d)``: element t maps the smoothed
    belief at t+1 to t; the terminal element is the constant filtered
    belief at T."""
    Pp = A @ fP[:-1] @ _mT(A) + Q  # predicted covs
    G = _mT(_solve_small(_mT(Pp), A @ _mT(fP[:-1]), pivot=False))  # P_f Aᵀ Pp⁻¹
    g = fm[:-1] - torch.einsum("t...ij,t...j->t...i", G @ A, fm[:-1])
    L = fP[:-1] - G @ Pp @ _mT(G)
    # Terminal element from fP[:1] (not G[:1]: G is empty when T = 1).
    return _SElem(
        torch.cat([G, torch.zeros_like(fP[:1])], dim=0),
        torch.cat([g, fm[-1:]], dim=0),
        torch.cat([L, fP[-1:]], dim=0),
    )


# ---------------------------------------------------------------------------
# Lane-major element algebra: replicas on the last axis.
#
# Leaves are laid out ``(..., d, d, R)`` / ``(..., d, R)`` with the replica
# axis last, as in the JAX package (where it lands on the TPU's vector
# lanes).  The port keeps the layout and the contracts, so the time-sharded
# smoother can share these helpers; each d x d product is d³ elementwise
# multiply-adds over the replicas.
# ---------------------------------------------------------------------------


def _lT(a: torch.Tensor) -> torch.Tensor:
    """Matrix transpose in lane layout: swap the (row, col) axes -3/-2."""
    return a.transpose(-3, -2)


def _lmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(..., i, k, R) @ (..., k, j, R) -> (..., i, j, R)`` as unrolled
    multiply-adds over the replica axis."""
    return (a[..., :, :, None, :] * b[..., None, :, :, :]).sum(-3)


def _lmv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(..., i, k, R) @ (..., k, R) -> (..., i, R)``."""
    return (a * v[..., None, :, :]).sum(-2)


def _lsolve(M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pivotless Gauss–Jordan ``solve(M, B)`` in lane layout:
    ``M (..., d, d, R)``, ``B (..., d, k, R)``.  Same validity condition as
    :func:`_solve_small` with ``pivot=False`` (see :func:`_combine`)."""
    d = M.shape[-3]
    aug = torch.cat([M, B], dim=-2)
    rows = torch.arange(d, device=M.device)[:, None, None]
    for i in range(d):
        piv_row = aug[..., i : i + 1, :, :] / aug[..., i : i + 1, i : i + 1, :]
        factors = aug[..., :, i : i + 1, :]
        aug = torch.where(rows == i, piv_row, aug - factors * piv_row)
    return aug[..., :, d:, :]


def _lcombine(e1: _Elem, e2: _Elem) -> _Elem:
    """:func:`_combine` in lane layout (e1 earlier, e2 later)."""
    d = e1.A.shape[-3]
    I = _eye(d, e1.A)[:, :, None]
    M = I + _lmm(e1.C, e2.J)
    rhs = torch.cat([e1.A, (e1.b + _lmv(e1.C, e2.eta))[..., :, None, :], e1.C], dim=-2)
    sol = _lsolve(M, rhs)
    MA, Mb, MC = sol[..., :, :d, :], sol[..., :, d, :], sol[..., :, d + 1 :, :]
    A = _lmm(e2.A, MA)
    b = _lmv(e2.A, Mb) + e2.b
    C = _lmm(_lmm(e2.A, MC), _lT(e2.A)) + e2.C
    Mt = I + _lmm(e2.J, e1.C)
    rhs_t = torch.cat([(e2.eta - _lmv(e2.J, e1.b))[..., :, None, :], e2.J], dim=-2)
    sol_t = _lsolve(Mt, rhs_t)
    eta = _lmv(_lT(e1.A), sol_t[..., :, 0, :]) + e1.eta
    J = _lmm(_lmm(_lT(e1.A), sol_t[..., :, 1:, :]), e1.A) + e1.J
    return _Elem(A, b, C, eta, J)


def _lscombine(e1: _SElem, e2: _SElem) -> _SElem:
    """:func:`_scombine` in lane layout (e1 later, e2 earlier)."""
    return _SElem(
        _lmm(e2.E, e1.E),
        _lmv(e2.E, e1.g) + e2.g,
        _lmm(_lmm(e2.E, e1.L), _lT(e2.E)) + e2.L,
    )


def _lanes(y):
    """``y (..., T, m)`` with the batch axes flattened onto a last lane axis:
    ``(T, m, L)``, and the batch shape."""
    T, m = y.shape[-2], y.shape[-1]
    return y.reshape((-1, T, m)).movedim(0, -1), tuple(y.shape[:-2])


def _build_filter_elems_lanes_component(y, A, Q, H, R, m0, P0):
    """Lane-major :func:`_build_filter_elems_component`: per-component
    masked elements with replicas on the last axis (per-step m-system
    solves by :func:`_lsolve`)."""
    d, m = A.shape[-1], y.shape[-1]
    yL, batch = _lanes(y)
    cL = (~torch.isnan(yL)).to(y.dtype)  # (T, m, L)
    yL = torch.where(cL > 0, yL, 0.0)
    L = yL.shape[-1]
    A_l, Q_l, H_l, R_l = A[..., None], Q[..., None], H[..., None], R[..., None]
    I_d = _eye(d, y)[:, :, None]
    I_m = _eye(m, y)[:, :, None]

    def masked_obs(c):  # c: (..., m, L)
        Hm = c[..., :, None, :] * H_l  # (..., m, d, L)
        Rm = c[..., :, None, :] * c[..., None, :, :] * R_l + (1.0 - c)[..., :, None, :] * I_m
        return Hm, Rm

    # Elements t >= 2.
    Hm, Rm = masked_obs(cL[1:])  # (T-1, m, ·, L)
    S = _lmm(_lmm(Hm, Q_l), _lT(Hm)) + Rm
    K = _lT(_lsolve(_lT(S), _lmm(Hm, _lT(Q_l))))  # Q H'ᵀ S⁻¹, (T-1, d, m, L)
    IKH = I_d - _lmm(K, Hm)
    HtSi = _lT(_lsolve(_lT(S), Hm))  # H'ᵀ S⁻¹, (T-1, d, m, L)
    AtHtSi = _lmm(_lT(A_l), HtSi)
    elems_rest = _Elem(
        _lmm(IKH, A_l),
        _lmv(K, yL[1:]),
        _lmm(IKH, Q_l),
        _lmv(AtHtSi, yL[1:]),
        _lmm(_lmm(AtHtSi, Hm), A_l),
    )

    # First element: prior-conditioned filtered belief of x_1 (A = 0).
    P0_l, m0_l = P0[..., None], m0[..., None]  # (d, d, 1), (d, 1)
    Hm1, Rm1 = masked_obs(cL[0])
    S1 = _lmm(_lmm(Hm1, P0_l), _lT(Hm1)) + Rm1
    K1 = _lT(_lsolve(_lT(S1), _lmm(Hm1, _lT(P0_l))))  # (d, m, L)
    b1 = m0_l + _lmv(K1, yL[0] - _lmv(Hm1, m0_l.expand(d, L)))
    C1 = _lmm(I_d - _lmm(K1, Hm1), P0_l)
    zd = torch.zeros((d, L), dtype=y.dtype, device=y.device)
    zdd = torch.zeros((d, d, L), dtype=y.dtype, device=y.device)
    elem1 = _Elem(zdd, b1.expand(d, L), C1.expand(d, d, L), zd, zdd)
    return _prepend(elem1, elems_rest), batch


def _build_filter_elems_lanes(
    y, A, Q, H, R, m0, P0, component_missing=False
) -> Tuple[_Elem, tuple]:
    """Lane-major :func:`_build_filter_elems`: ``y (..., T, m)`` with all
    leading batch dims flattened onto the last (lane) axis; returns elements
    with leaves ``(T, d, d, L)`` / ``(T, d, L)`` plus the original batch
    shape.  ``component_missing=True`` routes to the per-component masked
    builder (:func:`_build_filter_elems_lanes_component`)."""
    if component_missing:
        return _build_filter_elems_lanes_component(y, A, Q, H, R, m0, P0)
    d = A.shape[-1]
    yL, batch = _lanes(y)
    observed = ~torch.any(torch.isnan(yL), dim=-2)  # (T, L)
    yL = torch.where(observed[..., None, :], yL, 0.0)
    L = yL.shape[-1]
    I = _eye(d, y)

    # Generic per-step quantities (time-invariant model).
    S = H @ Q @ _mT(H) + R
    K = _mT(_solve_small(_mT(S), H @ _mT(Q), pivot=False))  # (d, m)
    IKH = I - K @ H
    HtSi = _mT(_solve_small(_mT(S), H, pivot=False))  # (d, m)
    J_g = (_mT(A) @ HtSi @ H @ A)[..., None]
    b_g = torch.einsum("dm,tmL->tdL", K, yL[1:])
    eta_g = torch.einsum("dm,tmL->tdL", _mT(A) @ HtSi, yL[1:])

    mrest = observed[1:, None, None, :]  # (T-1, 1, 1, L)
    elems_rest = _Elem(
        torch.where(mrest, (IKH @ A)[..., None], A[..., None]),
        torch.where(mrest[..., 0, :], b_g, 0.0),
        torch.where(mrest, (IKH @ Q)[..., None], Q[..., None]),
        torch.where(mrest[..., 0, :], eta_g, 0.0),
        torch.where(mrest, J_g, 0.0),
    )

    # First element: prior-conditioned filtered belief of x_1 (A = 0).
    S1 = H @ P0 @ _mT(H) + R
    K1 = _mT(_solve_small(_mT(S1), H @ _mT(P0), pivot=False))  # (d, m)
    m1 = observed[0]  # (L,)
    innov1 = yL[0] - (H @ m0)[:, None]  # (m, L)
    b1 = m0[:, None] + torch.where(m1, torch.einsum("dm,mL->dL", K1, innov1), 0.0)
    C1 = torch.where(m1, ((I - K1 @ H) @ P0)[..., None], P0[..., None]).expand(d, d, L)
    zd = torch.zeros((d, L), dtype=y.dtype, device=y.device)
    zdd = torch.zeros((d, d, L), dtype=y.dtype, device=y.device)
    return _prepend(_Elem(zdd, b1, C1, zd, zdd), elems_rest), batch


def _build_smoother_elems_lanes(fm, fP, A, Q) -> _SElem:
    """Lane-major :func:`_build_smoother_elems`: ``fm (T, ..., d, L)``,
    ``fP (T, ..., d, d, L)``."""
    A_l, Q_l = A.to(fm.dtype)[..., None], Q.to(fm.dtype)[..., None]
    Pp = _lmm(_lmm(A_l, fP[:-1]), _lT(A_l)) + Q_l
    G = _lT(_lsolve(_lT(Pp), _lmm(A_l, _lT(fP[:-1]))))  # P_f Aᵀ Pp⁻¹
    g = fm[:-1] - _lmv(_lmm(G, A_l), fm[:-1])
    L = fP[:-1] - _lmm(_lmm(G, Pp), _lT(G))
    # Terminal element from fP[:1] (not G[:1]: G is empty when T = 1).
    return _SElem(
        torch.cat([G, torch.zeros_like(fP[:1])], dim=0),
        torch.cat([g, fm[-1:]], dim=0),
        torch.cat([L, fP[-1:]], dim=0),
    )


def _lelem_identity(batch, d, lanes, dtype, device) -> _Elem:
    eye = torch.eye(d, dtype=dtype, device=device)[:, :, None].expand(
        tuple(batch) + (d, d, lanes))
    zd = torch.zeros(tuple(batch) + (d, lanes), dtype=dtype, device=device)
    zdd = torch.zeros(tuple(batch) + (d, d, lanes), dtype=dtype, device=device)
    return _Elem(eye, zd, zdd, zd, zdd)


def _lselem_identity(batch, d, lanes, dtype, device) -> _SElem:
    eye = torch.eye(d, dtype=dtype, device=device)[:, :, None].expand(
        tuple(batch) + (d, d, lanes))
    return _SElem(
        eye,
        torch.zeros(tuple(batch) + (d, lanes), dtype=dtype, device=device),
        torch.zeros(tuple(batch) + (d, d, lanes), dtype=dtype, device=device),
    )


def _at(elems, t):
    return _map(lambda a: a[t], elems)


def _lseq_filter_total(elems: _Elem, ident: _Elem) -> _Elem:
    """Sequential fold of lane-major elements over their leading axis."""
    total = ident
    for t in range(elems.A.shape[0]):
        total = _lcombine(total, _at(elems, t))
    return total


def _lseq_smoother_total(selems: _SElem, ident: _SElem) -> _SElem:
    """Sequential fold from the last element (``reverse=True``)."""
    total = ident
    for t in range(selems.E.shape[0] - 1, -1, -1):
        total = _lscombine(total, _at(selems, t))
    return total


def _lapply_filter_elem(b, C, e: _Elem):
    """Lane-major application of a filter element to the belief ``(b, C)``
    (one d-system solve)."""
    d = C.shape[-3]
    I = _eye(d, C)[:, :, None]
    M = I + _lmm(C, e.J)
    rhs = torch.cat([(b + _lmv(C, e.eta))[..., :, None, :], C], dim=-2)
    sol = _lsolve(M, rhs)
    nb = _lmv(e.A, sol[..., :, 0, :]) + e.b
    nC = _lmm(_lmm(e.A, sol[..., :, 1:, :]), _lT(e.A)) + e.C
    nC = 0.5 * (nC + _lT(nC))
    return nb, nC


def _lfilter_fillin(elems: _Elem, b0, C0):
    """Filtered moments of every element from the entering belief
    ``(b0, C0)``, stacked on the elements' leading axis."""
    bs, Cs = [], []
    for t in range(elems.A.shape[0]):
        b0, C0 = _lapply_filter_elem(b0, C0, _at(elems, t))
        bs.append(b0)
        Cs.append(C0)
    return torch.stack(bs), torch.stack(Cs)


def _lsmoother_fillin(selems: _SElem, last_g, last_L):
    """Smoothed moments of every element from the last one's ``(last_g,
    last_L)``, backward through the others."""
    ms, Ps = [last_g], [last_L]
    for t in range(selems.E.shape[0] - 2, -1, -1):
        e = _at(selems, t)
        ms.append(_lmv(e.E, ms[-1]) + e.g)
        Ps.append(_lmm(_lmm(e.E, Ps[-1]), _lT(e.E)) + e.L)
    return torch.stack(ms[::-1]), torch.stack(Ps[::-1])


def mv_lgssm_smooth(
    y: torch.Tensor,
    A,
    Q,
    H,
    R,
    prior: Tuple[object, object],
    *,
    component_missing: bool = False,
) -> MvChainMarginals:
    """Exact RTS-equivalent marginals for a vector-state LGSSM, by two
    associative scans over time.

    Parameters
    ----------
    y: ``(..., T, m)`` observations (leading axes = replicas).
    A, Q: ``(d, d)`` transition matrix / noise covariance.
    H: ``(m, d)`` observation matrix; R: ``(m, m)`` observation noise.
    prior: ``(m0 (d,), P0 (d, d))`` prior on the first state.
    component_missing: handle NaNs per observation component (per-step
        masked innovation systems) instead of degrading whole steps.

    O(log T) depth but O(T log T) work; single-device, prefer
    :func:`mv_lgssm_smooth_blocked` or :func:`mv_lgssm_smooth_seq`.
    """
    y = _observations(y, A, Q, H, R, prior)
    A, Q, H, R, m0, P0 = _like(y, A, Q, H, R, *prior)
    elems = _build_filter_elems(y, A, Q, H, R, m0, P0, component_missing=component_missing)
    filtered = _associative_scan(_combine, elems)
    selems = _build_smoother_elems(filtered.b, filtered.C, A, Q)
    smoothed = _associative_scan(_scombine, selems, reverse=True)
    return MvChainMarginals(
        smoothed.g.movedim(0, -2).contiguous(), smoothed.L.movedim(0, -3).contiguous()
    )


def _pick_blocks(T: int) -> int:
    """Largest divisor of T closest to √T (1 for prime T — degenerates to
    the sequential fold, still correct)."""
    target = max(1, int(round(T**0.5)))
    best = 1
    for b in range(1, T + 1):
        if T % b == 0 and abs(b - target) < abs(best - target):
            best = b
    return best


def mv_lgssm_smooth_blocked(
    y: torch.Tensor,
    A,
    Q,
    H,
    R,
    prior: Tuple[object, object],
    *,
    blocks: int = None,
    component_missing: bool = False,
) -> MvChainMarginals:
    """Exact RTS marginals by a two-level blocked scan.

    1. split T into B blocks; fold each block's elements into one combined
       element sequentially, batched over the B blocks (O(T) work),
    2. associative-scan the B block elements (B ≪ T combines),
    3. fill in each block sequentially from its entering belief — the
       forward fill-in is one d-system solve per step, the backward one 3
       products.

    The same marginals as :func:`mv_lgssm_smooth` (same algebra, same
    masked-NaN semantics, incl. ``component_missing=True``); depth
    4·T/B + O(log B), B ≈ √T by default (:func:`_pick_blocks`).  Runs in
    the lane-major layout.
    """
    y = _observations(y, A, Q, H, R, prior)
    A, Q, H, R, m0, P0 = _like(y, A, Q, H, R, *prior)
    d = A.shape[-1]
    T = y.shape[-2]
    B = blocks if blocks is not None else _pick_blocks(T)
    if T % B:
        raise ValueError(f"blocks={B} must divide T={T}")
    Tb = T // B

    elems, batch = _build_filter_elems_lanes(
        y, A, Q, H, R, m0, P0, component_missing=component_missing
    )
    lanes = elems.b.shape[-1]

    def to_blocks(a):  # (T, *r) -> (Tb, B, *r)
        return a.reshape((B, Tb) + tuple(a.shape[1:])).movedim(1, 0)

    def from_blocks(a):  # (Tb, B, *r) -> (T, *r)
        return a.movedim(0, 1).reshape((B * Tb,) + tuple(a.shape[2:]))

    eb = _map(to_blocks, elems)

    # 1-2. block totals (sequential, batched over B) + cross-block scan.
    ident = _lelem_identity((B,), d, lanes, y.dtype, y.device)
    totals = _lseq_filter_total(eb, ident)
    cum = _associative_scan(_lcombine, totals)
    # Entering belief per block: block k enters with blocks 0..k-1 folded.
    # Block 0 enters with the zero belief — its first element is the
    # prior-conditioned elem1 (A = 0), which overwrites it exactly.
    enter_b = torch.cat([torch.zeros_like(cum.b[:1]), cum.b[:-1]], dim=0)
    enter_C = torch.cat([torch.zeros_like(cum.C[:1]), cum.C[:-1]], dim=0)

    # 3. forward fill-in -> filtered moments, reassembled time-major.
    fb, fC = _lfilter_fillin(eb, enter_b, enter_C)
    fm, fP = from_blocks(fb), from_blocks(fC)  # (T, d, L), (T, d, d, L)

    # Backward: the same two-level scheme over the RTS affine elements.
    sb = _map(to_blocks, _build_smoother_elems_lanes(fm, fP, A, Q))
    sident = _lselem_identity((B,), d, lanes, y.dtype, y.device)
    stotals = _lseq_smoother_total(sb, sident)
    scum = _associative_scan(_lscombine, stotals, reverse=True)
    # Exclusive suffix per block (identity for the last block), applied to
    # each block's last element = smoothed moments at the block boundary.
    sexcl = _map(lambda a, i: torch.cat([a[1:], i[:1]], dim=0), scum, sident)
    slast = _lscombine(sexcl, _at(sb, -1))
    ms, Ps = _lsmoother_fillin(sb, slast.g, slast.L)
    mean = from_blocks(ms).movedim(-1, 0).reshape(batch + (T, d))
    cov = from_blocks(Ps).movedim(-1, 0).reshape(batch + (T, d, d))
    return MvChainMarginals(mean, cov)


def _mv_filter_scan(y, A, Q, H, R, prior):
    """Shared sequential filter: returns time-major (means, covs,
    loglik-per-step).

    Missing data is handled per component: a NaN in one observation
    component drops only that component's information — the masked update
    uses ``H' = diag(c) H`` and ``R' = diag(c) R diag(c) + diag(1-c)``, so
    the innovation system stays static-shaped and SPD; masked components
    contribute exactly zero to the state update and to the log evidence.
    A fully-NaN step degenerates to pure prediction with zero
    log-likelihood.
    """
    y = _observations(y, A, Q, H, R, prior)
    A, Q, H, R, m0, P0 = _like(y, A, Q, H, R, *prior)
    d = A.shape[-1]
    mdim = H.shape[-2]
    cmask = ~torch.isnan(y)  # (..., T, m) per component
    y = torch.where(cmask, y, 0.0)
    yT = y.movedim(-2, 0)
    cT = cmask.movedim(-2, 0)  # (T, ..., m)
    batch = tuple(yT.shape[1:-1])
    eye_m = _eye(mdim, y)

    def update(mean, P, obs, cm):
        # One pivotless Gauss–Jordan elimination of the SPD innovation
        # system yields S⁻¹innov, S⁻¹HP and log det S together.
        c = cm.to(y.dtype)  # (..., m)
        Hm = c[..., :, None] * H  # masked rows zeroed, (..., m, d)
        Rm = c[..., :, None] * c[..., None, :] * R + (1.0 - c)[..., :, None] * eye_m
        S = Hm @ P @ _mT(Hm) + Rm  # (..., m, m)
        innov = obs - torch.einsum("...md,...d->...m", Hm, mean)
        PHt = P @ _mT(Hm)
        rhs = torch.cat([innov[..., None], _mT(PHt)], dim=-1)
        sol, logdetS = _solve_small_logdet(S.expand(innov.shape[:-1] + (mdim, mdim)), rhs)
        u = sol[..., 0]  # S⁻¹ innov
        SiHP = sol[..., 1:]  # S⁻¹ H P, (..., m, d)
        # Masked components have unit diagonal in S (log det term 0) and
        # zero innovation; the 2π constant counts observed components only.
        ll = (
            -0.5 * torch.sum(innov * u, dim=-1)
            - 0.5 * logdetS
            - 0.5 * torch.sum(c, dim=-1) * math.log(2.0 * math.pi)
        )
        mean_u = mean + torch.einsum("...dm,...m->...d", PHt, u)
        P_u = P - PHt @ SiHP
        # Re-symmetrize every step: rounding in the elimination
        # asymmetrizes P, which compounds over long chains.
        P_u = 0.5 * (P_u + _mT(P_u))
        return mean_u, P_u, ll

    mean, P, ll = update(m0.expand(batch + (d,)), P0.expand(batch + (d, d)), yT[0], cT[0])
    means, covs, lls = [mean], [P], [ll]
    for obs, cm in zip(yT[1:], cT[1:]):
        mp = torch.einsum("ij,...j->...i", A, mean)
        Pp = A @ P @ _mT(A) + Q
        mean, P, ll = update(mp, Pp, obs, cm)
        means.append(mean)
        covs.append(P)
        lls.append(ll)
    return torch.stack(means), torch.stack(covs), torch.stack(lls)


def mv_lgssm_smooth_seq(
    y: torch.Tensor,
    A,
    Q,
    H,
    R,
    prior: Tuple[object, object],
) -> MvChainMarginals:
    """Sequential RTS smoother: the filter forward and the RTS recursion
    backward, each a loop over time batched over replicas.  The same
    marginals as :func:`mv_lgssm_smooth`; NaNs are masked per component."""
    means, covs, _ = _mv_filter_scan(y, A, Q, H, R, prior)
    A, Q = _like(means, A, Q)
    ms, Ps = [means[-1]], [covs[-1]]
    for t in range(means.shape[0] - 2, -1, -1):
        mf, Pf = means[t], covs[t]
        Pp = A @ Pf @ _mT(A) + Q
        G = _mT(_solve_small(_mT(Pp), A @ _mT(Pf), pivot=False))
        ms.append(mf + torch.einsum(
            "...de,...e->...d", G, ms[-1] - torch.einsum("de,...e->...d", A, mf)))
        Ps.append(Pf + G @ (Ps[-1] - Pp) @ _mT(G))
    ms = torch.stack(ms[::-1])
    Ps = torch.stack(Ps[::-1])
    return MvChainMarginals(ms.movedim(0, -2).contiguous(), Ps.movedim(0, -3).contiguous())


class MvSmootherOperator(NamedTuple):
    """Precompiled affine smoother: ``means = y·L + c``, covs constant.

    For a time-invariant LGSSM the smoothed means are affine in the stacked
    observations and the smoothed covariances do not depend on the data, so
    the sweep is one ``(R, T·m) @ (T·m, T·d)`` product against a
    precomputed operator plus a constant covariance track.  Dense data only
    (a NaN changes the operator)."""

    L: torch.Tensor  # (T*m, T*d)
    c: torch.Tensor  # (T, d) affine offset (prior contribution)
    cov: torch.Tensor  # (T, d, d) data-independent smoothed covariances


def mv_lgssm_smoother_operator(
    T: int,
    A,
    Q,
    H,
    R,
    prior: Tuple[object, object],
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> MvSmootherOperator:
    """Build the affine operator by smoothing the T·m unit-impulse inputs as
    one batch (linearity: column k of L is ``smooth(e_k) - smooth(0)``), on
    ``device`` (the card unless the caller asks for another)."""
    m = to_tensor(H).shape[-2]
    d = to_tensor(A).shape[-1]
    basis = torch.cat(
        [torch.zeros((1, T * m), dtype=dtype, device=device),
         torch.eye(T * m, dtype=dtype, device=device)],
        dim=0,
    ).reshape(T * m + 1, T, m)
    out = mv_lgssm_smooth_seq(basis, A, Q, H, R, prior)
    c = out.mean[0]  # (T, d): response to all-zero observations
    L = (out.mean[1:] - c).reshape(T * m, T * d)
    return MvSmootherOperator(L, c, out.cov[0])


def mv_lgssm_smooth_matmul(
    y: torch.Tensor,
    A=None,
    Q=None,
    H=None,
    R=None,
    prior: Tuple[object, object] = None,
    operator: MvSmootherOperator = None,
) -> MvChainMarginals:
    """Smoothing as one matrix product against a precomputed affine operator,
    in full float32 (TF32 off).  The same marginals as
    :func:`mv_lgssm_smooth` for dense data; pass ``operator=`` to build it
    once for many sweeps.  The covariances are a broadcast view."""
    y = _observations(y, A, Q, H, R, prior, operator)
    T, m = y.shape[-2], y.shape[-1]
    if operator is None:
        operator = mv_lgssm_smoother_operator(T, A, Q, H, R, prior, y.dtype, y.device)
    d = operator.c.shape[-1]
    batch = tuple(y.shape[:-2])
    flat = y.reshape(batch + (T * m,))
    with _full_float32_matmul():
        means = (flat @ operator.L.to(y.dtype)).reshape(batch + (T, d)) + operator.c.to(y.dtype)
    cov = operator.cov.to(y.dtype).expand(batch + (T, d, d))
    return MvChainMarginals(means, cov)


def mv_lgssm_filter(
    y: torch.Tensor,
    A,
    Q,
    H,
    R,
    prior: Tuple[object, object],
) -> MvChainMarginals:
    """Filtered beliefs p(x_t | y_{1:t}) for the vector-state LGSSM
    (streaming posterior).  Same parameter contract as
    :func:`mv_lgssm_smooth`; NaNs are masked per component and fully-NaN
    steps predict through the gap."""
    means, covs, _ = _mv_filter_scan(y, A, Q, H, R, prior)
    return MvChainMarginals(means.movedim(0, -2).contiguous(), covs.movedim(0, -3).contiguous())


def mv_lgssm_log_evidence(
    y: torch.Tensor,
    A,
    Q,
    H,
    R,
    prior: Tuple[object, object],
) -> torch.Tensor:
    """log p(y_{1:T}) by the prediction-error decomposition, shape
    ``y.shape[:-2]`` (one value per replica).  Differentiable in all
    parameters (the ML system-identification hook for vector models); NaN
    components are marginalized analytically, per component."""
    _, _, lls = _mv_filter_scan(y, A, Q, H, R, prior)
    return torch.sum(lls, dim=0)
