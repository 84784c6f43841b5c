"""The operations and bytes each measured kernel and each whole call needs,
counted from the shapes alone: each input byte read once, each output byte
written once, whatever a kernel reads again.

Copied from the program and frozen, so that a later change to the program
cannot move the yardstick: :func:`k1` is ``kernels.COSTS["lgssm_smooth"]``
and :func:`k3` is ``kernels_hmm._cost(..., counts=True)`` of
``cortex_tpu_torch/ops``, as they stood when this benchmark was written.
Every function returns ``(operations, bytes)``.
"""

from __future__ import annotations

from typing import Tuple

F32 = 4


def k1(R: int, T: int) -> Tuple[float, float]:
    """K1, the fused LGSSM sweep over ``(R, T)`` float32 observations: about 8
    operations a replica-step; y read, mean and variance written (12 B a
    replica-step), and the coefficient rows."""
    return 8.0 * R * T, 12.0 * R * T + 12.0 * T


def k3(R: int, T: int, K: int) -> Tuple[float, float]:
    """K3, the scaled HMM forward-backward with the summed pairwise counts, on
    ``(R, T, K)`` float32 likelihoods: lik, A and pi read; gamma, the
    log-evidence and xi_sum written; 4K^2 + 9K operations a replica-step for
    the passes and 2K^2 + 3K for the counts."""
    nbytes = F32 * (2 * R * T * K + R + K * K + K + R * K * K)
    return float(R * T * (6 * K * K + 12 * K)), float(nbytes)


def lgssm_call(R: int, T: int) -> Tuple[float, float]:
    """One LGSSM smoothing call of ``R`` replicas of ``T`` float32
    observations: the observations read once, the marginal means and
    variances written once, and one sweep's operations (K1's count)."""
    return 8.0 * R * T, float(F32 * 3 * R * T)


def hmm_fit(R: int, T: int, K: int, M: int, n_iterations: int,
            obs_bytes: int = 8) -> Tuple[float, float]:
    """A pooled Dirichlet VMP fit of ``n_iterations`` over ``(R, T)``
    observations of ``obs_bytes`` bytes each, with its final smoothing pass.

    Bytes: the observations read once; the final posterior (state marginals
    ``(R, T, K)``, pairwise counts ``(R, K, K)``, log-evidence ``(R,)``), the
    Dirichlet posteriors and the ELBO written once, float32.  Operations:
    ``n + 1`` forward-backward passes with their pairwise counts at K3's count
    a replica-step, and ``n`` M-steps, each adding every step's state
    marginals into the emission counts (K a replica-step) and every replica's
    pairwise counts into the pooled ones (K^2 a replica).  The per-step
    log-likelihoods are a gather of ``log B`` by symbol: no operation.
    """
    passes = (n_iterations + 1) * R * T * (6 * K * K + 12 * K)
    m_steps = n_iterations * (R * T * K + R * K * K)
    written = F32 * (R * T * K + R * K * K + R + K * K + K * M + 1)
    return float(passes + m_steps), float(R * T * obs_bytes + written)
