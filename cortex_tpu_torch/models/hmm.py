"""Hidden Markov model: forward-backward smoothing + Dirichlet VMP learning, in PyTorch.

The counterpart of ``cortex_tpu/models/hmm.py``.  State marginals come from
sum-product sweeps on the chain (:mod:`cortex_tpu_torch.ops.hmm`, or the
fused CUDA kernel); the transition matrix and the categorical emission
matrix carry Dirichlet posteriors updated by variational message passing:

    E-step:  forward-backward under θ̃ = exp(E_q[log θ])  (digamma means)
    M-step:  α_post = α_prior + expected transition/emission counts

The ELBO is tracked in closed form: ``ELBO = log Z̃ − Σ KL(q(θ_row) ‖ p(θ_row))``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.special import digamma, gammaln

from ..dists import Dirichlet
from ..ops.chains import _full_float32_matmul
from ..ops.hmm import HMMPosterior, hmm_forward_backward, hmm_viterbi
from ..ops.kernels_hmm import FLOOR, hmm_forward_backward_counts_fused

__all__ = ["HMM", "HMMVMPState", "HMMVMPResult"]

_METHODS = ("scan", "fused")


def _dirichlet_kl(alpha_q: torch.Tensor, alpha_p: torch.Tensor) -> torch.Tensor:
    """KL(Dir(alpha_q) ‖ Dir(alpha_p)) along the last axis."""
    a0q = torch.sum(alpha_q, dim=-1)
    a0p = torch.sum(alpha_p, dim=-1)
    return (
        gammaln(a0q)
        - torch.sum(gammaln(alpha_q), dim=-1)
        - gammaln(a0p)
        + torch.sum(gammaln(alpha_p), dim=-1)
        + torch.sum((alpha_q - alpha_p) * (digamma(alpha_q) - digamma(a0q)[..., None]), dim=-1)
    )


def _check_method(method: str) -> None:
    if method not in _METHODS:
        raise ValueError(f"Unknown method: {method!r} (expected one of {_METHODS})")


class HMMVMPState(NamedTuple):
    trans_alpha: torch.Tensor  # (..., K, K) Dirichlet posterior rows over A
    emis_alpha: Optional[torch.Tensor]  # (..., K, M)


class HMMVMPResult(NamedTuple):
    state: HMMVMPState
    posterior: HMMPosterior
    elbo: torch.Tensor  # (...,) per replica, final iteration


class HMM(nn.Module):
    """Discrete HMM with ``K`` hidden states and initial log-distribution
    ``log_pi`` (K,), held as a buffer: the model computes on the device it
    was moved to, which must be that of its inputs.

    Emissions are either fixed (pass per-step log-likelihoods to
    :meth:`smooth`) or categorical over M symbols with a Dirichlet posterior
    (:meth:`fit_vmp` with integer observations).  Calling the module smooths.
    """

    def __init__(self, K: int, log_pi: torch.Tensor):
        super().__init__()
        self.K = int(K)
        log_pi = torch.as_tensor(log_pi)
        if tuple(log_pi.shape) != (self.K,):
            raise ValueError(f"log_pi must have shape ({self.K},), got {tuple(log_pi.shape)}")
        self.register_buffer("log_pi", log_pi)

    def extra_repr(self) -> str:
        return f"K={self.K}"

    def forward(self, log_lik, log_A, method: str = "scan") -> HMMPosterior:
        """Same as :meth:`smooth`."""
        return self.smooth(log_lik, log_A, method)

    # -- sum-product smoothing with known parameters -------------------------
    def smooth(
        self, log_lik: torch.Tensor, log_A: torch.Tensor, method: str = "scan"
    ) -> HMMPosterior:
        """Forward-backward state marginals given per-step log-likelihoods.

        ``method="fused"`` runs the scaled kernel on ``exp(log_lik)`` (which
        needs ``log_lik`` of shape ``(R, T, K)`` and one ``log_A``); results
        come back in the same log-space :class:`HMMPosterior`, with the
        kernel's linear-space floors (see :mod:`~cortex_tpu_torch.ops.kernels_hmm`).
        """
        _check_method(method)
        if method == "fused":
            if log_lik.dim() != 3:
                raise ValueError("method='fused' requires log_lik of shape (R, T, K)")
            out = hmm_forward_backward_counts_fused(
                torch.exp(log_lik), torch.exp(log_A), torch.exp(self.log_pi)
            )
            return HMMPosterior(
                torch.log(out.gamma + FLOOR), torch.log(out.xi_sum + FLOOR), out.log_evidence
            )
        return hmm_forward_backward(log_lik, log_A, self.log_pi)

    def viterbi(self, log_lik: torch.Tensor, log_A: torch.Tensor) -> torch.Tensor:
        return hmm_viterbi(log_lik, log_A, self.log_pi)

    # -- Dirichlet VMP over transitions and categorical emissions -------------
    def fit_vmp(
        self,
        obs: torch.Tensor,
        n_symbols: int,
        n_iterations: int = 20,
        trans_prior: float = 1.0,
        emis_prior: float = 1.0,
        init_state: Optional[HMMVMPState] = None,
        method: str = "scan",
        pooled: bool = False,
    ) -> HMMVMPResult:
        """Variational EM with Dirichlet posteriors over the transition rows
        and the categorical emission rows.

        ``obs``: integer observations ``(..., T)`` in ``[0, n_symbols)``, on
        the model's device.  Missing steps are ``-1``: their one-hot row is
        all-zero, so the step contributes a uniform (zero log-) likelihood to
        the E-step and nothing to the emission counts.  Leading axes are
        independent replicas, each with its own posterior, unless
        ``pooled=True``: then ONE shared posterior is learned from all
        replicas (expected counts summed across the batch).

        ``method``: ``"scan"`` (log-space forward-backward) or ``"fused"``
        (the CUDA kernel emitting marginals and pairwise counts; it requires
        ``pooled=True`` with obs of shape ``(R, T)``, since the kernel holds
        one shared transition matrix).  The final smoothing pass is always
        the log-space scan.
        """
        _check_method(method)
        if method == "fused" and not (pooled and obs.dim() == 2):
            raise ValueError("method='fused' requires pooled=True and obs of shape (R, T)")
        if n_iterations < 1:
            raise ValueError(f"n_iterations must be at least 1, got {n_iterations}")
        K, M = self.K, n_symbols
        dtype, device = self.log_pi.dtype, obs.device
        batch = () if pooled else tuple(obs.shape[:-1])
        # One-hot by comparison: an obs of -1 (or out of range) gives a zero row.
        onehot = (obs[..., None] == torch.arange(M, device=device)).to(dtype)  # (..., T, M)

        if init_state is None:
            # Symmetry breaking: tilt the transition prior towards
            # self-persistence (deterministic, replica-independent).
            eye = torch.eye(K, dtype=dtype, device=device)
            tilt = (torch.arange(K, device=device) % M)[:, None] == torch.arange(M, device=device)
            init_state = HMMVMPState(
                (trans_prior + 0.5 * eye).expand(batch + (K, K)),
                (emis_prior + 0.25 * tilt.to(dtype)).expand(batch + (K, M)),
            )
        trans_prior_arr = torch.full((K, K), trans_prior, dtype=dtype, device=device)
        emis_prior_arr = torch.full((K, M), emis_prior, dtype=dtype, device=device)
        reduce_dims = tuple(range(obs.dim() - 1)) if pooled and obs.dim() > 1 else ()

        def e_step(log_lik, log_A):
            if method == "fused":
                out = hmm_forward_backward_counts_fused(
                    torch.exp(log_lik), torch.exp(log_A), torch.exp(self.log_pi)
                )
                return out.gamma, out.xi_sum, out.log_evidence
            post = hmm_forward_backward(log_lik, log_A, self.log_pi)
            return torch.exp(post.log_gamma), torch.exp(post.log_xi_sum), post.log_evidence

        state = init_state
        with _full_float32_matmul():  # keeps the one-hot einsums exact under a TF32 setting
            for _ in range(n_iterations):
                # E[log θ] under the Dirichlet posteriors (digamma means).
                log_A = Dirichlet(state.trans_alpha).mean_log()
                log_B = Dirichlet(state.emis_alpha).mean_log()
                log_lik = torch.einsum("...tm,...km->...tk", onehot, log_B)
                gamma, trans_counts, log_evidence = e_step(log_lik, log_A)
                emis_counts = torch.einsum("...tk,...tm->...km", gamma, onehot)
                if reduce_dims:
                    # Sum expected statistics across replicas (one shared model).
                    trans_counts = trans_counts.sum(dim=reduce_dims)
                    emis_counts = emis_counts.sum(dim=reduce_dims)
                    log_evidence = log_evidence.sum(dim=reduce_dims)
                state = HMMVMPState(trans_prior_arr + trans_counts, emis_prior_arr + emis_counts)
                elbo = (
                    log_evidence
                    - torch.sum(_dirichlet_kl(state.trans_alpha, trans_prior_arr), dim=-1)
                    - torch.sum(_dirichlet_kl(state.emis_alpha, emis_prior_arr), dim=-1)
                )
            # Final smoothing pass under the final posterior.
            log_A = Dirichlet(state.trans_alpha).mean_log()
            log_B = Dirichlet(state.emis_alpha).mean_log()
            log_lik = torch.einsum("...tm,...km->...tk", onehot, log_B)
            post = hmm_forward_backward(log_lik, log_A, self.log_pi)
        return HMMVMPResult(state, post, elbo)
