"""Time-sharded LGSSM smoothing: a distributed associative scan over a mesh axis.

The counterpart of ``cortex_tpu/parallel/time_sharded.py``.  A long chain's
time axis is split into contiguous blocks, one per rank along ``time_axis``,
and the chain's message passing is reformulated as an associative scan
(the elements and combines of :mod:`cortex_tpu_torch.ops.chains`),
distributed in three steps:

1. each rank folds its time block's elements into one element,
2. the per-block elements (one small tuple per rank) are exchanged by a
   single ``all_gather`` over the ``time`` group — the only traffic between
   ranks, whatever the chain's length,
3. each rank fills its block in from the exclusive prefix of the earlier
   blocks' elements.

The same runs in reverse for the smoother pass.  For the scalar chain a
rank's own work is :class:`~cortex_tpu_torch.ops.kernels_time_sharded.
LocalSweep`'s three passes, each reading the block once (a sequential fold
and fill-in per lane, cut into time segments): CUDA kernels on a float32
block on the card, their plain PyTorch version on any other block.  The
vector chain's is a sequential fold and fill-in in the lane-major layout.  A
call is one span, ``parallel.time_sharded`` (``parallel.mv_time_sharded``
for the vector chain), the root of its call record
(:mod:`cortex_tpu_torch.utils.spans`); its two exchanges are
``collective.all_gather`` spans inside it.

Explicit SPMD: every rank of the axis calls the function on its own block
(see :func:`cortex_tpu_torch.parallel.shard`) and gets the marginals of its
own block back; the split of the global ``T`` over the ranks is
:func:`~cortex_tpu_torch.parallel.shard`'s, which raises on a ragged one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.chains import (
    ChainMarginals,
    _FilterElem,
    _SmootherElem,
    _filter_combine,
    _smoother_combine,
)
from ..ops.chains_mv import (
    MvChainMarginals,
    _Elem,
    _SElem,
    _lcombine,
    _lfilter_fillin,
    _like,
    _lmm,
    _lmv,
    _lscombine,
    _lseq_filter_total,
    _lseq_smoother_total,
    _lsmoother_fillin,
    _lsolve,
    _lT,
    _mT,
    _solve_small,
)
from ..ops.kernels_time_sharded import LocalSweep
from ..utils import spans
from ..utils.tree import to_tensor
from .mesh import Mesh, all_gather

__all__ = ["lgssm_smooth_time_sharded", "mv_lgssm_smooth_time_sharded"]


def _exclusive_prefix(gathered, combine, identity, my_index: int):
    """Fold ``gathered[i]`` for ``i < my_index`` into a single element."""
    acc = identity
    for i in range(my_index):
        acc = combine(acc, gathered[i])
    return acc


def _exclusive_suffix(gathered, combine, identity, my_index: int):
    """Fold ``gathered[i]`` for ``i > my_index`` into a single element
    (reverse direction: accumulate from the far end towards my block)."""
    acc = identity
    for i in range(len(gathered) - 1, my_index, -1):
        acc = combine(acc, gathered[i])
    return acc


def _gather_elems(elem, mesh: Mesh, axis: str):
    """Every rank's element along ``axis``, by one ``all_gather`` of its
    fields stacked into one tensor: a list of elements in axis order."""
    kind = type(elem)
    sizes = [field.numel() for field in elem]
    flat = torch.cat([field.reshape(-1) for field in elem])
    gathered = all_gather(flat, mesh, axis)
    return [
        kind(*(part.reshape(field.shape) for part, field in zip(row.split(sizes), elem)))
        for row in gathered
    ]


def lgssm_smooth_time_sharded(
    y: torch.Tensor,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    *,
    mesh: Mesh,
    time_axis: str = "time",
    prior: Optional[Tuple[float, float]] = None,
) -> ChainMarginals:
    """Smooth this rank's block ``y`` of shape ``(..., T_blk)`` of a chain whose
    time axis is split over ``time_axis`` in axis order.

    Exact Kalman/RTS marginals of the block, shaped like ``y``; each sweep
    exchanges one filter 5-tuple and one smoother 3-tuple per rank.
    """
    with spans.span("parallel.time_sharded"):
        return _sweep(y, A, Q, H, R, prior, mesh.axis_index(time_axis), mesh.shape[time_axis],
                      lambda elem: _gather_elems(elem, mesh, time_axis))


def _sweep(y, A, Q, H, R, prior, my: int, ndev: int, gather) -> ChainMarginals:
    """Rank ``my`` of ``ndev``'s sweep of its block: :class:`~cortex_tpu_torch.
    ops.kernels_time_sharded.LocalSweep`'s three passes, each reading the block
    once, around two exchanges; ``gather(elem)`` is every rank's ``elem`` in
    axis order.  A strided block is copied first."""
    shape = y.shape
    block = y.reshape(-1, shape[-1]).contiguous()
    lanes = block.shape[0]
    first, last = my == 0, my == ndev - 1
    lane_prior = None
    if first and prior is not None:
        lane_prior = tuple(
            to_tensor(p, dtype=y.dtype, device=y.device).expand(shape[:-1]).reshape(lanes)
            for p in prior)
    sweep = LocalSweep(block, A, Q, H, R, first=first, last=last, prior=lane_prior)

    gathered = gather(_FilterElem(*sweep.filter_total()))
    one, zero = torch.ones_like(block[:, 0]), torch.zeros_like(block[:, 0])
    prefix = _exclusive_prefix(
        gathered, _filter_combine, _FilterElem(one, zero, zero, zero, zero), my)
    sgathered = gather(_SmootherElem(*sweep.filter_fillin(prefix.b, prefix.C)))
    suffix = _exclusive_suffix(
        sgathered, _smoother_combine, _SmootherElem(one, zero, zero), my)
    mean, variance = sweep.smoother_fillin(*suffix)
    return ChainMarginals(mean.view(shape), variance.view(shape))


def mv_lgssm_smooth_time_sharded(
    y: torch.Tensor,
    A,
    Q,
    H,
    R,
    prior,
    *,
    mesh: Mesh,
    time_axis: str = "time",
    missing: str = "none",
):
    """Vector-state analogue of :func:`lgssm_smooth_time_sharded`.

    ``y``: this rank's block ``(..., T_blk, m)`` of a chain whose time axis
    is split over ``time_axis``; ``A, Q: (d, d)``, ``H: (m, d)``, ``R: (m,
    m)``, ``prior=(m0 (d,), P0 (d, d))``, taken in the dtype and on the
    device of ``y``.  Exact marginals of the block — one filter element (A,
    b, C, eta, J) and one smoother element (E, g, L) exchanged per rank.
    Each rank works in the lane-major layout (replicas last;
    ``ops/chains_mv.py``'s lane-major helpers): a sequential O(T_blk) local
    fold and fill-in, the distributed form of
    :func:`cortex_tpu_torch.ops.mv_lgssm_smooth_blocked` with the rank's
    index standing in for the block index.

    ``missing="none"`` (default): dense data only — the shared per-step
    elements assume every component observed, and NaNs propagate.
    ``missing="component"``: per-component NaN masking in information form
    (a NaN in one observation component keeps the others' information;
    fully-NaN steps predict through), at the cost of per-step lane-major
    m-system solves in the element build.
    """
    with spans.span("parallel.mv_time_sharded"):
        return _mv_smooth_time_sharded(y, A, Q, H, R, prior, mesh, time_axis, missing)


def _mv_smooth_time_sharded(y, A, Q, H, R, prior, mesh: Mesh, time_axis: str, missing: str):
    if missing not in ("none", "component"):
        raise ValueError(
            f"unknown missing={missing!r}; expected 'none' or 'component'"
        )
    A, Q, H, R, m0, P0 = _like(y, A, Q, H, R, *prior)
    d = A.shape[-1]
    mdim = H.shape[-2]
    ndev = mesh.shape[time_axis]
    my = mesh.axis_index(time_axis)
    I = torch.eye(d, dtype=y.dtype, device=y.device)
    Tb = y.shape[-2]
    batch = tuple(y.shape[:-2])
    # Flatten the replica batch onto the lane axis: (Tb, m, L).
    yL = y.reshape((-1, Tb, mdim)).movedim(0, -1)
    lanes = yL.shape[-1]

    def lane(mat):
        return mat[..., None]

    if missing == "component":
        # Per-step masked elements (H' = diag(c)H, R' = diag(c)Rdiag(c) +
        # diag(1-c)), the embedding of the single-device component builders;
        # per-step lane m-system solves instead of the shared elements.
        cL = (~torch.isnan(yL)).to(y.dtype)  # (Tb, m, L)
        yL = torch.where(cL > 0, yL, 0.0)
        A_l, Q_l = lane(A), lane(Q)
        I_m = torch.eye(mdim, dtype=y.dtype, device=y.device)[:, :, None]
        Hm = cL[:, :, None, :] * lane(H)  # (Tb, m, d, L)
        Rm = cL[:, :, None, :] * cL[:, None, :, :] * lane(R) + (1.0 - cL)[:, :, None, :] * I_m
        S_l = _lmm(_lmm(Hm, Q_l), _lT(Hm)) + Rm
        K_l = _lT(_lsolve(_lT(S_l), _lmm(Hm, _lT(Q_l))))
        IKH_l = I[:, :, None] - _lmm(K_l, Hm)
        HtSi_l = _lT(_lsolve(_lT(S_l), Hm))
        AtHtSi = _lmm(_lT(A_l), HtSi_l)
        A_e = _lmm(IKH_l, A_l)
        C_e = _lmm(IKH_l, Q_l)
        J_e = _lmm(_lmm(AtHtSi, Hm), A_l)
        b_e = _lmv(K_l, yL)
        eta_e = _lmv(AtHtSi, yL)
        if my == 0:
            # First global element: masked prior-conditioned belief of x_1.
            P0_l = lane(P0)
            m0_l = m0[:, None]  # (d, 1)
            S1_l = _lmm(_lmm(Hm[0], P0_l), _lT(Hm[0])) + Rm[0]
            K1_l = _lT(_lsolve(_lT(S1_l), _lmm(Hm[0], _lT(P0_l))))
            b1 = m0_l + _lmv(K1_l, yL[0] - _lmv(Hm[0], m0_l.expand(d, lanes)))
            C1 = _lmm(I[:, :, None] - _lmm(K1_l, Hm[0]), P0_l)
    else:
        # Generic filter elements for all local steps (lane-major).
        S = H @ Q @ _mT(H) + R
        K = _mT(_solve_small(_mT(S), H @ _mT(Q), pivot=False))
        IKH = I - K @ H
        HtSi = _mT(_solve_small(_mT(S), H, pivot=False))
        full = (Tb, d, d, lanes)
        A_e = lane(IKH @ A).expand(full)
        C_e = lane(IKH @ Q).expand(full)
        J_e = lane(_mT(A) @ HtSi @ H @ A).expand(full)
        b_e = torch.einsum("dm,tmL->tdL", K, yL)
        eta_e = torch.einsum("dm,tmL->tdL", _mT(A) @ HtSi, yL)
        if my == 0:
            # First global element: filtered belief of x_1 from the prior.
            S1 = H @ P0 @ _mT(H) + R
            K1 = _mT(_solve_small(_mT(S1), H @ _mT(P0), pivot=False))
            b1 = m0[:, None] + torch.einsum("dm,mL->dL", K1, yL[0] - (H @ m0)[:, None])
            C1 = lane((I - K1 @ H) @ P0)
    if my == 0:
        zdd = torch.zeros((1, d, d, lanes), dtype=y.dtype, device=y.device)
        zd = torch.zeros((1, d, lanes), dtype=y.dtype, device=y.device)
        A_e = torch.cat([zdd, A_e[1:]])
        b_e = torch.cat([b1.expand(d, lanes)[None], b_e[1:]])
        C_e = torch.cat([C1.expand(d, d, lanes)[None], C_e[1:]])
        eta_e = torch.cat([zd, eta_e[1:]])
        J_e = torch.cat([zdd, J_e[1:]])
    elems = _Elem(A_e, b_e, C_e, eta_e, J_e)

    zd = torch.zeros((d, lanes), dtype=y.dtype, device=y.device)
    zdd = torch.zeros((d, d, lanes), dtype=y.dtype, device=y.device)
    eye = I[:, :, None] + zdd

    # Local block total by a sequential fold: O(T_blk) combines.
    ident = _Elem(eye, zd, zdd, zd, zdd)
    block_total = _lseq_filter_total(elems, ident)
    gathered = _gather_elems(block_total, mesh, time_axis)
    prefix = _exclusive_prefix(gathered, _lcombine, ident, my)
    # Fill in the block from the entering belief (prefix has A = 0 on every
    # rank but the first, where elem1 overwrites the zero belief exactly) —
    # one d-system solve per step.
    fm, fP = _lfilter_fillin(elems, prefix.b, prefix.C)

    # Smoother elements (lane-major; the LOCAL last element is a regular one
    # — it maps into the next rank's first step — except on the globally
    # last rank, where it is terminal).
    A_l, Q_l = lane(A), lane(Q)
    Pp = _lmm(_lmm(A_l, fP), _lT(A_l)) + Q_l
    G = _lT(_lsolve(_lT(Pp), _lmm(A_l, _lT(fP))))
    g = fm - _lmv(_lmm(G, A_l), fm)
    L = fP - _lmm(_lmm(G, Pp), _lT(G))
    if my == ndev - 1:
        G[-1] = 0.0
        g[-1] = fm[-1]
        L[-1] = fP[-1]
    selems = _SElem(G, g, L)

    sident = _SElem(eye, zd, zdd)
    sblock_total = _lseq_smoother_total(selems, sident)
    sgathered = _gather_elems(sblock_total, mesh, time_axis)
    suffix = _exclusive_suffix(sgathered, _lscombine, sident, my)
    # Smoothed moments at the block's LAST position, then the backward
    # fill-in for the interior.
    slast = _lscombine(suffix, _SElem(*(f[-1] for f in selems)))
    ms, Ps = _lsmoother_fillin(selems, slast.g, slast.L)
    # (Tb, d, L) / (Tb, d, d, L) -> (..., Tb, d) / (..., Tb, d, d).
    mean = ms.movedim(-1, 0).reshape(batch + (Tb, d))
    cov = Ps.movedim(-1, 0).reshape(batch + (Tb, d, d))
    return MvChainMarginals(mean, cov)
