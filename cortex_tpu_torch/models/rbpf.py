"""Rao-Blackwellized particle filter for switching LGSSMs, in PyTorch.

The counterpart of ``cortex_tpu/models/rbpf.py``, and the marginalized
complement of :class:`cortex_tpu_torch.models.SLDS`'s IMM filter: sample only
the discrete regime path per particle and run an exact scalar Kalman filter
conditioned on it.  The continuous state is integrated out analytically, so
Monte-Carlo variance lives only on the K-ary regime chain; with K = 1 there
is no randomness and the log-evidence estimate equals the exact Kalman
evidence.

Particles are one more batch axis: a loop over time carries ``(..., N)``
regime indices, Kalman moments and log-weights, with adaptive systematic
resampling (:mod:`cortex_tpu_torch.models.particle`).  Where the JAX package
filters one sequence and gets replicas by ``vmap``, the port takes leading
replica axes, each replica with its own particle set and its own draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.chains import scalar_kalman_update
from ..utils.tree import as_tensors
from .particle import _resample
from .slds import SLDS, _sample_categorical

__all__ = ["RBPFResult", "rbpf_filter"]


class RBPFResult(NamedTuple):
    """``regime_probs``: ``(..., T, K)`` weighted-particle regime posterior;
    ``mean``/``variance``: ``(..., T)`` Rao-Blackwellized state beliefs;
    ``log_evidence``: ``(...)`` marginal-likelihood estimate;
    ``ess``: ``(..., T)`` effective sample size before resampling."""

    regime_probs: torch.Tensor
    mean: torch.Tensor
    variance: torch.Tensor
    log_evidence: torch.Tensor
    ess: torch.Tensor


def rbpf_filter(
    generator: torch.Generator,
    model: SLDS,
    y: torch.Tensor,
    n_particles: int = 512,
    ess_threshold: float = 0.5,
) -> RBPFResult:
    """Filter the sequences ``y`` of shape ``(..., T)`` (leading replica axes),
    drawing from ``generator``.  Resampling triggers per replica when its ESS
    drops below ``ess_threshold * n_particles``.  A ``y`` that is not a tensor
    becomes float32 on the model's device."""
    y, = as_tensors(y, default=model.Pi.device)
    Pi, A, Q, H, R = model.Pi, model.A, model.Q, model.H, model.R
    K, N = model.K, n_particles
    batch = tuple(y.shape[:-1])
    yT = y.movedim(-1, 0)[..., None]  # (T, ..., 1): broadcast against particles

    def kalman_update(s, m_pred, v_pred, obs):
        return scalar_kalman_update(obs, m_pred, v_pred, H[s], R[s])

    def moments(logw, s, m, v):
        w = torch.softmax(logw, dim=-1)
        probs = torch.zeros(batch + (K,), dtype=y.dtype, device=y.device).scatter_add_(-1, s, w)
        mean = torch.sum(w * m, dim=-1)
        var = torch.sum(w * (v + (m - mean[..., None]) ** 2), dim=-1)
        ess = 1.0 / torch.sum(w**2, dim=-1)
        return probs, mean, var, ess

    cdf_Pi = torch.cumsum(Pi, dim=-1)
    s = _sample_categorical(generator, torch.cumsum(model.w0, dim=-1).expand(batch + (N, K)))
    full = torch.full(batch + (N,), model.prior[0], dtype=y.dtype, device=y.device)
    m, v, ll = kalman_update(s, full, torch.full_like(full, model.prior[1]), yT[0])
    logZ = torch.logsumexp(ll, dim=-1) - math.log(N)
    logw = ll - torch.logsumexp(ll, dim=-1, keepdim=True)
    out = [moments(ll, s, m, v)]
    for obs in yT[1:]:
        # Propose regimes from the prior chain (bootstrap proposal).
        s_new = _sample_categorical(generator, cdf_Pi[s])
        m_pred = A[s_new] * m
        v_pred = A[s_new] * A[s_new] * v + Q[s_new]
        m_new, v_new, ll = kalman_update(s_new, m_pred, v_pred, obs)
        logw_new = logw + ll
        logZ = logZ + torch.logsumexp(logw_new, dim=-1) - torch.logsumexp(logw, dim=-1)
        out.append(moments(logw_new, s_new, m_new, v_new))
        # Adaptive systematic resampling.
        idx = _resample(generator, logw_new)
        do = (out[-1][3] < ess_threshold * N)[..., None]
        s = torch.where(do, torch.gather(s_new, -1, idx), s_new)
        m = torch.where(do, torch.gather(m_new, -1, idx), m_new)
        v = torch.where(do, torch.gather(v_new, -1, idx), v_new)
        logw = torch.where(do, 0.0, logw_new)
    probs, means, varis, esses = zip(*out)
    return RBPFResult(
        torch.stack(probs, dim=-2), torch.stack(means, dim=-1), torch.stack(varis, dim=-1),
        logZ, torch.stack(esses, dim=-1))
