"""Variational / Bethe free energy — generic helpers, in PyTorch.

The counterpart of ``cortex_tpu/ops/free_energy.py``:

- :func:`elbo_conjugate` — the structured-VMP identity
  ``ELBO = log Z̃ − Σ KL(q(θ) ‖ p(θ))`` for conjugate models whose E-step is
  exact under expected-log parameters,
- :func:`bethe_free_energy_chain` — the Bethe free energy of a Gaussian
  chain from its observation messages (exact −log Z on trees).

The JAX ``lax.scan`` over time is a Python loop here, with the same update
order, each step updating every replica at once.
"""

from __future__ import annotations

import math

import torch

__all__ = ["elbo_conjugate", "bethe_free_energy_chain"]


def elbo_conjugate(log_evidence_tilde: torch.Tensor, *kl_terms: torch.Tensor) -> torch.Tensor:
    """``ELBO = log Z̃ − Σ KL``; inputs broadcast across replica axes."""
    out = log_evidence_tilde
    for kl in kl_terms:
        out = out - kl
    return out


def bethe_free_energy_chain(
    obs_xi: torch.Tensor,
    obs_w: torch.Tensor,
    Q: float,
    A: float = 1.0,
) -> torch.Tensor:
    """Bethe free energy of a scalar Gaussian chain, shape ``(...)``.

    For tree graphs the Bethe free energy equals the exact negative log
    evidence, which for the chain is a closed-form functional of the
    observation messages alone (``(..., T)`` information-form tensors),
    computed by the prediction-error decomposition.  ``y_1`` anchors the
    no-prior convention: the result is ``−log p(y_2..T | y_1)``.
    """
    # xi = H y / R_, w = H^2 / R_ with H = 1: y = xi / w, R_ = 1 / w.
    yT = (obs_xi / obs_w).movedim(-1, 0)
    RT = (1.0 / obs_w).movedim(-1, 0)
    m, v = yT[0], RT[0]
    ll = torch.zeros(yT.shape[1:], dtype=yT.dtype, device=yT.device)
    for y_t, r_t in zip(yT[1:], RT[1:]):
        pm, pv = A * m, A * A * v + Q
        s = pv + r_t
        ll = ll - 0.5 * (torch.log(2.0 * math.pi * s) + (y_t - pm) ** 2 / s)
        k = pv / s
        m = pm + k * (y_t - pm)
        v = pv - k * pv
    return -ll
