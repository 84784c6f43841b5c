"""Loopy Gaussian belief propagation on arbitrary pairwise MRFs, in PyTorch.

The counterpart of ``cortex_tpu/ops/gabp.py``: synchronous (Jacobi) GaBP,
where every directed edge's message updates at once per iteration —

    gather (reverse messages) → elementwise update → scatter-add

over packed edge arrays, a Python loop over iterations, replicas broadcast
on leading axes.  For walk-summable models the fixed-point means are the
exact posterior means (Weiss & Freeman 2001); variances are the standard
GaBP approximation (exact on trees).  The scatter is ``index_add``, whose
float atomics on a card add in an order that differs from run to run, so
results agree with another run to rounding, not bit for bit.

Model, information form:  p(x) ∝ exp(−½ xᵀΛx + ηᵀx)  with sparse Λ given as
node diagonals ``lam_diag`` and undirected edges ``(edges, lam_off)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dists.gaussian import _device
from ..utils.tree import as_float32_tensor

__all__ = ["GaBPResult", "gabp_solve", "gabp_grid_solve", "grid_edges"]


class GaBPResult(NamedTuple):
    """Marginal beliefs: ``mean`` shaped like ``eta`` (``(..., n)``);
    ``variance`` shaped ``(n,)`` (precisions depend only on the shared graph,
    not on the per-replica ``eta``); ``delta`` — the max message change at
    the last iteration (convergence diagnostic)."""

    mean: torch.Tensor
    variance: torch.Tensor
    delta: torch.Tensor


def grid_edges(h: int, w: int) -> np.ndarray:
    """Undirected 4-neighbor grid edge list, shape ``(E, 2)`` — the standard
    loopy-BP benchmark topology (image denoising / smoothing)."""
    idx = np.arange(h * w).reshape(h, w)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return np.concatenate([right, down], axis=0)


def _max_change(new, old):
    return torch.max(torch.abs(new - old))


def gabp_solve(
    lam_diag,
    eta,
    edges,
    lam_off,
    n_iters: int = 50,
    damping: float = 0.7,
) -> GaBPResult:
    """Run synchronous damped GaBP; returns marginal means/variances.

    ``lam_diag``: ``(n,)`` node precisions (Λ_ii); ``eta``: ``(..., n)``
    information vector (leading axes are independent replicas sharing the
    graph); ``edges``: ``(E, 2)`` undirected vertex pairs; ``lam_off``:
    ``(E,)`` off-diagonal couplings Λ_ij.  Requires Λ_ii > 0; convergence is
    guaranteed for walk-summable (e.g. diagonally dominant) models.
    """
    dev = _device(eta, lam_diag, lam_off)
    lam_diag, eta, lam_off = (as_float32_tensor(a, dev) for a in (lam_diag, eta, lam_off))
    edges = torch.as_tensor(edges, device=dev).long()
    n = lam_diag.shape[-1]
    E = edges.shape[0]

    # Directed edge arrays: edge e < E is u→v, edge e+E is v→u; the reverse
    # of directed edge d is (d + E) mod 2E.
    src = torch.cat([edges[:, 0], edges[:, 1]])
    dst = torch.cat([edges[:, 1], edges[:, 0]])
    lam_e = torch.cat([lam_off, lam_off])
    batch_shape = tuple(eta.shape[:-1])

    def reverse(m):
        return torch.roll(m, E, dims=-1)

    def inbound(m, like):
        """Node aggregates of the messages ``m`` (summed at their targets)."""
        return torch.zeros(tuple(m.shape[:-1]) + (n,), dtype=like.dtype,
                           device=dev).index_add_(-1, dst, m)

    m_lam = torch.zeros((2 * E,), dtype=lam_diag.dtype, device=dev)
    m_eta = torch.zeros(batch_shape + (2 * E,), dtype=eta.dtype, device=dev)
    delta = torch.zeros((), dtype=eta.dtype, device=dev)
    for it in range(n_iters):
        agg_lam, agg_eta = inbound(m_lam, lam_diag), inbound(m_eta, eta)
        # Cavity at the source of each directed edge: all inbound except the
        # reverse message.
        cav_lam = lam_diag[src] + agg_lam[src] - reverse(m_lam)
        cav_eta = eta[..., src] + agg_eta[..., src] - reverse(m_eta)
        new_lam = -(lam_e**2) / cav_lam
        new_eta = -lam_e * cav_eta / cav_lam
        m_lam_next = (1.0 - damping) * m_lam + damping * new_lam
        m_eta_next = (1.0 - damping) * m_eta + damping * new_eta
        if it == n_iters - 1:  # only the last iteration's change is returned
            delta = torch.maximum(_max_change(m_lam_next, m_lam), _max_change(m_eta_next, m_eta))
        m_lam, m_eta = m_lam_next, m_eta_next

    post_lam = lam_diag + inbound(m_lam, lam_diag)
    post_eta = eta + inbound(m_eta, eta)
    return GaBPResult(post_eta / post_lam, 1.0 / post_lam, delta)


def _shift(x, d):
    """Move values to the neighbor the message flows into (zero fill)."""
    if d == 0:  # into-from-left plane: source value at (i, j-1)
        return F.pad(x[..., :, :-1], (1, 0))
    if d == 1:
        return F.pad(x[..., :, 1:], (0, 1))
    if d == 2:
        return F.pad(x[..., :-1, :], (0, 0, 1, 0))
    return F.pad(x[..., 1:, :], (0, 0, 0, 1))


def gabp_grid_solve(
    lam_diag,
    eta,
    lam_off: float,
    n_iters: int = 50,
    damping: float = 0.7,
) -> GaBPResult:
    """Grid-specialized GaBP: identical marginals to :func:`gabp_solve` on a
    4-neighbor grid with uniform coupling, but *stencil-shaped* — messages
    live in four dense ``(H, W)`` direction planes updated with shifted
    slices, so one iteration is elementwise work with no gather or scatter.

    ``lam_diag``: ``(H, W)`` node precisions; ``eta``: ``(..., H, W)``
    (leading replica axes); ``lam_off``: scalar coupling Λ_ij of every edge.
    """
    dev = _device(eta, lam_diag)
    lam_diag, eta = as_float32_tensor(lam_diag, dev), as_float32_tensor(eta, dev)
    H, W = lam_diag.shape
    batch = tuple(eta.shape[:-2])
    w2 = lam_off * lam_off

    # m_*[d] = message INTO node (i, j) from its neighbor in direction d:
    # 0: from left (i, j-1), 1: from right (i, j+1), 2: from above (i-1, j),
    # 3: from below (i+1, j).  Border messages are structurally zero and kept
    # zero by masking.
    ones = torch.ones((H, W), dtype=lam_diag.dtype, device=dev)
    mask = [_shift(ones, d) > 0 for d in range(4)]
    opposite = (1, 0, 3, 2)

    m_lam = [torch.zeros((H, W), dtype=lam_diag.dtype, device=dev) for _ in range(4)]
    m_eta = [torch.zeros(batch + (H, W), dtype=eta.dtype, device=dev) for _ in range(4)]
    delta = torch.zeros((), dtype=eta.dtype, device=dev)
    for it in range(n_iters):
        tot_lam = lam_diag + sum(m_lam)
        tot_eta = eta + sum(m_eta)
        new_lam, new_eta = [], []
        for d in range(4):
            # Cavity at the SOURCE node of the message arriving from
            # direction d: everything except what the target sent back.
            cav_lam = _shift(tot_lam - m_lam[opposite[d]], d)
            cav_eta = _shift(tot_eta - m_eta[opposite[d]], d)
            safe = torch.where(mask[d], cav_lam, 1.0)
            nl = torch.where(mask[d], -w2 / safe, 0.0)
            ne = torch.where(mask[d], -lam_off * cav_eta / safe, 0.0)
            new_lam.append((1.0 - damping) * m_lam[d] + damping * nl)
            new_eta.append((1.0 - damping) * m_eta[d] + damping * ne)
        if it == n_iters - 1:  # only the last iteration's change is returned
            delta = torch.stack([torch.maximum(_max_change(nl, ol), _max_change(ne, oe))
                                 for nl, ol, ne, oe in zip(new_lam, m_lam, new_eta, m_eta)]).max()
        m_lam, m_eta = new_lam, new_eta

    post_lam = lam_diag + sum(m_lam)
    post_eta = eta + sum(m_eta)
    return GaBPResult(post_eta / post_lam, 1.0 / post_lam, delta)
