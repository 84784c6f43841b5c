"""Bootstrap particle filter — Monte-Carlo state-space inference, in PyTorch.

The counterpart of ``cortex_tpu/models/particle.py``.  Particles are one more
batch axis, so a particle filter is a loop over time on ``(..., N, ...)``
tensors.  Where the JAX package takes one sequence and gets replicas by
``vmap``, the port takes leading replica axes (``batch_ndim``), each replica
with its own particle set and its own resampling offsets.

Generic over the model: the user supplies ``transition(generator, x) -> x'``
and ``log_likelihood(y, x) -> logw`` (both vectorized over the particle
axis).  Resampling is systematic (low-variance), by an O(N) scatter-max and
``cummax`` inversion of the weight CDF (:func:`systematic_indices`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.tree import as_tensors

__all__ = [
    "ParticleFilterResult",
    "particle_filter",
    "systematic_indices",
    "systematic_resample",
]


class ParticleFilterResult(NamedTuple):
    means: torch.Tensor  # (..., T, ...) posterior mean per step
    variances: torch.Tensor  # (..., T, ...) posterior variance per step
    log_evidence: torch.Tensor  # (...) incremental log p(y_{1:T}) estimate
    ess: torch.Tensor  # (..., T) effective sample size before resampling
    particles: torch.Tensor  # (..., N, ...) final particle set


def systematic_indices(log_weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Systematic resampling of ``log_weights (..., N)`` at the offsets ``u``
    (shape ``log_weights.shape[:-1]``, in [0, 1)): int32 indices ``(..., N)``,
    as JAX returns them.  Arrays that are not tensors become float32 on the
    device of the tensors among them, or on the card."""
    return _indices(*as_tensors(log_weights, u)).to(torch.int32)


def _indices(log_weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`systematic_indices` as int64, the type gather and scatter take.

    The stratified positions ``(j + u)/N`` are sorted, so particle ``i``'s
    children occupy the output slots ``[C_{i-1}, C_i)`` with ``C_i =
    ceil(N·cdf_i − u)``: a scatter-max of the segment starts followed by a
    ``cummax`` recovers the owner of every slot.  A start equal to N (no slot
    left) lands in one spare slot that is cut off, where JAX drops it.
    """
    n = log_weights.shape[-1]
    cdf = torch.cumsum(torch.softmax(log_weights, dim=-1), dim=-1)
    C = torch.clamp(torch.ceil(cdf * n - u[..., None]), 0, n).to(torch.int64)
    starts = torch.cat([torch.zeros_like(C[..., :1]), C[..., :-1]], dim=-1)
    owners = torch.zeros(C.shape[:-1] + (n + 1,), dtype=torch.int64, device=C.device)
    owners = owners.scatter_reduce(
        -1, starts, torch.arange(n, device=C.device).expand_as(starts), "amax")
    return torch.cummax(owners[..., :n], dim=-1).values


def systematic_resample(generator: torch.Generator, log_weights: torch.Tensor) -> torch.Tensor:
    """Systematic (low-variance) resampling: one uniform offset per replica
    from ``generator``, then :func:`systematic_indices` (int32 indices)."""
    return _resample(generator, *as_tensors(log_weights)).to(torch.int32)


def _resample(generator: torch.Generator, log_weights: torch.Tensor) -> torch.Tensor:
    """:func:`systematic_resample` as int64, the type gather takes."""
    u = torch.rand(log_weights.shape[:-1], generator=generator, device=log_weights.device,
                   dtype=log_weights.dtype)
    return _indices(log_weights, u)


def _squeeze_tail(x: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    """``x`` without the size-1 axes after the first ``batch_ndim``."""
    return x.reshape(x.shape[:batch_ndim] + tuple(s for s in x.shape[batch_ndim:] if s != 1))


def particle_filter(
    generator: torch.Generator,
    y: torch.Tensor,
    transition: Callable[[torch.Generator, torch.Tensor], torch.Tensor],
    log_likelihood: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    init_particles: torch.Tensor,
    ess_threshold: float = 0.5,
    batch_ndim: int = 0,
) -> ParticleFilterResult:
    """Bootstrap particle filter over observations ``y``.

    With ``batch_ndim = 0`` (one sequence, as in the JAX package): ``y`` is
    ``(T, ...)`` and ``init_particles`` ``(N, ...)``.  With leading replica
    axes: ``y`` is ``(*batch, T, ...)``, ``init_particles`` ``(*batch, N,
    ...)``, and ``log_likelihood`` gets each ``y_t`` with a particle axis of
    length 1 after the replica axes.  Resampling triggers per replica when its
    effective sample size drops below ``ess_threshold * N``.  Returns per-step
    moments, the log-evidence estimate and the ESS trace, each replica's as
    the JAX package returns one sequence's (size-1 state axes squeezed).
    Arrays that are not tensors become float32 on the device of the tensors
    among ``y`` and ``init_particles``, else on the generator's.
    """
    y, init_particles = as_tensors(y, init_particles, default=generator.device)
    nb = batch_ndim
    batch, n = init_particles.shape[:nb], init_particles.shape[nb]
    state_ndim = init_particles.dim() - nb - 1
    yT = y.movedim(nb, 0)
    n_thresh = ess_threshold * n
    particles = init_particles
    dtype, device = init_particles.dtype, init_particles.device
    log_w = torch.zeros(batch + (n,), dtype=dtype, device=device)
    logZ = torch.zeros(batch, dtype=dtype, device=device)
    means, variances, esses = [], [], []
    for y_t in yT:
        # Propagate through the transition (bootstrap proposal).
        particles = transition(generator, particles)
        # Weight update + evidence increment.
        log_l = log_likelihood(y_t.unsqueeze(nb) if nb else y_t, particles)
        log_w = log_w + log_l
        logZ = logZ + torch.logsumexp(log_w, -1) - torch.logsumexp(log_w - log_l, -1)

        w = torch.softmax(log_w, dim=-1)
        esses.append(1.0 / torch.sum(w**2, dim=-1))
        flat = particles.reshape(batch + (n, -1))
        mean = torch.sum(w[..., None] * flat, dim=nb)
        means.append(mean)
        variances.append(torch.sum(w[..., None] * (flat - mean.unsqueeze(nb)) ** 2, dim=nb))

        # Adaptive systematic resampling.
        idx = _resample(generator, log_w)
        do_resample = esses[-1] < n_thresh
        idx = idx.reshape(idx.shape + (1,) * state_ndim).expand(particles.shape)
        particles = torch.where(
            do_resample.reshape(batch + (1,) * (state_ndim + 1)),
            torch.gather(particles, nb, idx), particles)
        log_w = torch.where(do_resample[..., None], 0.0, log_w)

    tail = (len(yT),) + (tuple(init_particles.shape[nb + 1:]) or (1,))
    return ParticleFilterResult(
        _squeeze_tail(torch.stack(means, nb).reshape(batch + tail), nb),
        _squeeze_tail(torch.stack(variances, nb).reshape(batch + tail), nb),
        logZ,
        torch.stack(esses, -1),
        particles,
    )
