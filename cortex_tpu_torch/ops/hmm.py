"""Discrete-chain message passing: HMM forward-backward and Viterbi, in PyTorch.

The counterpart of ``cortex_tpu/ops/hmm.py``: sum-product on a chain of
categorical variables as forward/backward loops over time, batched over
replicas in the leading axes.  Messages are kept in log space
(``torch.logsumexp`` recursions); marginals and pairwise marginals come out
normalized.

Shapes: ``log_lik``: ``(..., T, K)``; ``log_A``: ``(K, K)`` (row = from-state)
or batched ``(..., K, K)``; ``log_pi``: ``(K,)`` or ``(..., K)``.  Inputs that
are not tensors become float32 tensors on the device of the tensors among
them, or on the card; tensors are kept as given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import spans
from ..utils.tree import as_tensors

__all__ = ["HMMPosterior", "hmm_forward_backward", "hmm_viterbi"]


class HMMPosterior(NamedTuple):
    log_gamma: torch.Tensor  # (..., T, K) state marginals
    log_xi_sum: torch.Tensor  # (..., K, K) summed pairwise marginals (counts)
    log_evidence: torch.Tensor  # (...,) log p(y_{1:T})


def hmm_forward_backward(
    log_lik: torch.Tensor, log_A: torch.Tensor, log_pi: torch.Tensor
) -> HMMPosterior:
    """Sum-product forward-backward on the HMM chain.

    Forward messages ``alpha`` and backward messages ``beta`` by loops over
    ``T``, marginals ``gamma ∝ alpha·beta``, and the pairwise expected counts
    summed over time (the sufficient statistics of Dirichlet VMP).
    """
    with spans.span("ops.hmm_forward_backward"):
        log_lik, log_A, log_pi = as_tensors(log_lik, log_A, log_pi)
        llT = log_lik.movedim(-2, 0)  # (T, ..., K)
        T = llT.shape[0]

        # Forward: alpha_t(k) = loglik_t(k) + lse_j(alpha_{t-1}(j) + log_A[j,k])
        alphas = [log_pi + llT[0]]
        for t in range(1, T):
            alphas.append(llT[t] + torch.logsumexp(alphas[-1][..., :, None] + log_A, dim=-2))
        alphas = torch.stack(alphas)  # (T, ..., K)

        # Backward: beta_{T-1} = 0;
        # beta_t(j) = lse_k(log_A[j,k] + loglik_{t+1}(k) + beta_{t+1}(k))
        betas = [torch.zeros_like(alphas[-1])]
        for t in range(T - 2, -1, -1):
            betas.append(torch.logsumexp(log_A + (llT[t + 1] + betas[-1])[..., None, :], dim=-1))
        betas = torch.stack(betas[::-1])

        log_Z = torch.logsumexp(alphas[-1], dim=-1)
        log_gamma = alphas + betas - log_Z[None, ..., None]

        # Pairwise: xi_t(j,k) ∝ alpha_t(j) + log_A[j,k] + loglik_{t+1}(k) + beta_{t+1}(k)
        log_xi = (
            alphas[:-1][..., :, None]
            + log_A
            + (llT[1:] + betas[1:])[..., None, :]
            - log_Z[None, ..., None, None]
        )  # (T-1, ..., K, K)
        log_xi_sum = torch.logsumexp(log_xi, dim=0)
        return HMMPosterior(log_gamma.movedim(0, -2), log_xi_sum, log_Z)


def hmm_viterbi(
    log_lik: torch.Tensor, log_A: torch.Tensor, log_pi: torch.Tensor
) -> torch.Tensor:
    """Max-product (MAP path) on the chain, shape ``(..., T)`` int32, as JAX
    returns it.  Ties go to the lowest state index, as in ``jnp.argmax``."""
    log_lik, log_A, log_pi = as_tensors(log_lik, log_A, log_pi)
    llT = log_lik.movedim(-2, 0)
    delta = log_pi + llT[0]
    args = []
    for t in range(1, llT.shape[0]):
        best, arg = torch.max(delta[..., :, None] + log_A, dim=-2)
        delta = llT[t] + best
        args.append(arg)
    path = [torch.argmax(delta, dim=-1)]
    for arg in reversed(args):
        path.append(torch.gather(arg, -1, path[-1][..., None])[..., 0])
    # gather takes int64 indices: the path is cast once, at the end.
    return torch.stack(path[::-1], dim=-1).to(torch.int32)
