"""Hidden Markov model: forward-backward smoothing + Dirichlet VMP learning, in PyTorch.

The counterpart of ``cortex_tpu/models/hmm.py``.  State marginals come from
sum-product sweeps on the chain (:mod:`cortex_tpu_torch.ops.hmm`, or the
fused CUDA kernel); the transition matrix and the categorical emission
matrix carry Dirichlet posteriors updated by variational message passing:

    E-step:  forward-backward under θ̃ = exp(E_q[log θ])  (digamma means)
    M-step:  α_post = α_prior + expected transition/emission counts

The ELBO is tracked in closed form: ``ELBO = log Z̃ − Σ KL(q(θ_row) ‖ p(θ_row))``.

A fit runs eagerly: each VMP iteration and the final log-space pass are a
Python loop of tensor operations on the device of its inputs.  On the card,
a :meth:`HMM.fit_vmp` whose signature (its inputs' shapes and dtypes, the
model's ``log_pi``'s, and every argument that is not a tensor) repeats on
one model is captured into one ``torch.cuda.CUDAGraph`` at its second call
and replayed from then on: the call's ``obs``, its ``init_state`` and the
model's current ``log_pi`` are copied into the graph's input buffers, and
the results are returned as copies, fresh tensors each call.  A fit whose
capture fails runs eagerly for good.  A model keeps at most
:data:`GRAPH_CAP` graphs; a copy or a pickle of it keeps none.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.special import digamma, gammaln

from ..dists import Dirichlet
from ..ops.chains import _full_float32_matmul
from ..ops.hmm import HMMPosterior, hmm_forward_backward, hmm_viterbi
from ..ops.kernels_hmm import FLOOR, hmm_forward_backward_counts_fused
from ..utils import spans
from ..utils.tree import as_float32_tensor, as_tensors, input_device, tree_map

__all__ = ["HMM", "HMMVMPState", "HMMVMPResult", "GRAPH_CAP"]

_METHODS = ("scan", "fused")

# Captured fits one HMM keeps; a capture beyond them evicts the least
# recently used.
GRAPH_CAP = 4

# Fits on the card that ran from a captured graph, captures made, and fits
# on the card that ran eagerly (a signature's first call, or one whose
# capture failed).
_GRAPH = spans.counter_group("model.hmm.graph", ("captures", "replays", "eager"))


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
    was moved to, which must be that of its tensor inputs.  A ``log_pi`` that
    is not a tensor becomes float32 on the card; inputs that are not tensors
    become float32 (``obs``: int32) on the device of the tensors among them,
    else on the buffer's.

    Emissions are either fixed (pass per-step log-likelihoods to
    :meth:`smooth`) or categorical over M symbols with a Dirichlet posterior
    (:meth:`fit_vmp` with integer observations).  Calling the module smooths.
    """

    def __init__(self, K: int, log_pi: torch.Tensor):
        super().__init__()
        self.K = int(K)
        log_pi = as_float32_tensor(log_pi, input_device(log_pi))
        if tuple(log_pi.shape) != (self.K,):
            raise ValueError(f"log_pi must have shape ({self.K},), got {tuple(log_pi.shape)}")
        self.register_buffer("log_pi", log_pi)
        self._fits = _FitGraphs()

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
        log_lik, log_A = self._inputs(log_lik, log_A)
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
        """The MAP state path, ``(..., T)`` int32 (:func:`hmm_viterbi`)."""
        return hmm_viterbi(*self._inputs(log_lik, log_A), self.log_pi)

    def _inputs(self, *xs):
        """``xs`` as :func:`~cortex_tpu_torch.utils.tree.as_tensors` takes them,
        on the device of ``log_pi`` where no tensor among them names one."""
        return as_tensors(*xs, default=self.log_pi.device)

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

        On the card, the first call of a signature runs eagerly, the second
        is captured into a CUDA graph (a failed capture marks the signature
        eager for good), and later ones replay it.  The signature is ``obs``'s
        shape and dtype, ``init_state``'s (or its absence), ``log_pi``'s, the
        device, ``n_symbols``, ``n_iterations``, both priors, ``method`` and
        ``pooled``.  A replay reads the call's ``obs`` and ``init_state`` and
        the model's ``log_pi`` as they are at the call, and returns fresh
        tensors, equal bit for bit to the eager fit's.  A call inside an
        outer capture runs eagerly, and that capture records it.
        """
        with spans.span("model.hmm.fit_vmp"):
            _check_method(method)
            with spans.span("boundary.inputs"):
                obs, *init = self._inputs(obs, *(init_state or ()))
                leaves = [self.log_pi, obs, *init]
                key = _signature(
                    _static(self.K, n_symbols, n_iterations, trans_prior, emis_prior,
                            method, pooled, bool(init)), leaves)
            if method == "fused" and not (pooled and obs.dim() == 2):
                raise ValueError("method='fused' requires pooled=True and obs of shape (R, T)")
            if n_iterations < 1:
                raise ValueError(f"n_iterations must be at least 1, got {n_iterations}")

            def fit(log_pi, obs, *init):
                return _fit_vmp(log_pi, obs, HMMVMPState(*init) if init else None, self.K,
                                n_symbols, n_iterations, trans_prior, emis_prior, method, pooled)

            return self._fits(key, fit, leaves)


def _fit_vmp(log_pi, obs, init_state, K, M, n_iterations, trans_prior, emis_prior, method,
             pooled) -> HMMVMPResult:
    """:meth:`HMM.fit_vmp` on checked inputs, reading ``log_pi`` as given."""
    dtype, device = log_pi.dtype, obs.device
    batch = () if pooled else tuple(obs.shape[:-1])
    # One-hot by comparison: an obs of -1 (or out of range) gives a zero row.
    onehot = (obs[..., None] == torch.arange(M, device=device)).to(dtype)  # (..., T, M)

    if init_state is None:
        # Symmetry breaking: tilt the transition prior towards
        # self-persistence (deterministic, replica-independent).
        eye = torch.eye(K, dtype=dtype, device=device)
        tilt = ((torch.arange(K, device=device) % M)[:, None]
                == torch.arange(M, device=device))
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
                torch.exp(log_lik), torch.exp(log_A), torch.exp(log_pi)
            )
            return out.gamma, out.xi_sum, out.log_evidence
        post = hmm_forward_backward(log_lik, log_A, log_pi)
        return torch.exp(post.log_gamma), torch.exp(post.log_xi_sum), post.log_evidence

    state = init_state
    with _full_float32_matmul():  # keeps the one-hot einsums exact under a TF32 setting
        for _ in range(n_iterations):
            with spans.span("model.hmm.vmp_iteration"):
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
                state = HMMVMPState(trans_prior_arr + trans_counts,
                                    emis_prior_arr + emis_counts)
                elbo = (
                    log_evidence
                    - torch.sum(_dirichlet_kl(state.trans_alpha, trans_prior_arr), dim=-1)
                    - torch.sum(_dirichlet_kl(state.emis_alpha, emis_prior_arr), dim=-1)
                )
        # Final smoothing pass under the final posterior.
        log_A = Dirichlet(state.trans_alpha).mean_log()
        log_B = Dirichlet(state.emis_alpha).mean_log()
        log_lik = torch.einsum("...tm,...km->...tk", onehot, log_B)
        post = hmm_forward_backward(log_lik, log_A, log_pi)
    return HMMVMPResult(state, post, elbo)


# -- captured fits on the card ---------------------------------------------------


def _static(K, n_symbols, n_iterations, trans_prior, emis_prior, method, pooled,
            init_given: bool) -> Optional[Tuple]:
    """The arguments of a fit that are not tensors, as a key: each with its
    type (the priors as floats, as the fit reads them).  ``None`` where one
    is a tensor (the fit would read it back from the device) or does not
    hash or convert (the eager fit raises)."""
    values = (K, n_symbols, n_iterations, method, pooled)
    if any(isinstance(v, torch.Tensor) for v in values + (trans_prior, emis_prior)):
        return None
    try:
        key = (tuple((type(v), v) for v in values), float(trans_prior), float(emis_prior),
               init_given)
        hash(key)
    except (TypeError, ValueError):
        return None
    return key


def _signature(static: Optional[Tuple], leaves: Sequence[Any]) -> Optional[Tuple]:
    """The key under which a fit is captured and replayed: ``static``, the
    device, and each leaf's shape and dtype (``log_pi``, ``obs``, then
    ``init_state``'s leaves).  ``None`` where the fit is not one to capture:
    no ``static``, a leaf that is not a tensor on the card, leaves on two
    cards, or a stream already capturing (an outer capture records the
    eager fit)."""
    if static is None or not all(isinstance(x, torch.Tensor) for x in leaves):
        return None
    device = leaves[0].device
    if device.type != "cuda" or any(x.device != device for x in leaves):
        return None
    if torch.cuda.is_current_stream_capturing():
        return None
    return static, device, tuple((tuple(x.shape), x.dtype) for x in leaves)


class _CapturedFit:
    """One fit captured into a CUDA graph: the call's tensors copied into
    fixed buffers, the graph that fits from them, and the result it writes."""

    def __init__(self, fit: Callable, leaves: Sequence[torch.Tensor]) -> None:
        device = leaves[0].device
        self.buffers = [x.clone() for x in leaves]
        # A warm-up on a side stream first, as torch's rule for capture asks.
        caller = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            fit(*self.buffers)
        caller.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # The outer stream context restores the caller's stream where a
        # failed capture leaves torch.cuda.graph's own unrestored.
        with torch.cuda.device(device), torch.cuda.stream(caller):
            with torch.cuda.graph(self.graph):
                self.result = fit(*self.buffers)

    def __call__(self, leaves: Sequence[torch.Tensor]) -> HMMVMPResult:
        with spans.span("model.hmm.replay"):
            for buffer, leaf in zip(self.buffers, leaves):
                buffer.copy_(leaf)
            self.graph.replay()
            _GRAPH["replays"] += 1
            return tree_map(torch.clone, self.result)


class _FitGraphs:
    """One model's fits on the card by signature: captured (least recently
    used first), seen once, and those whose capture failed.  A copy or a
    pickle starts empty, since graphs do not copy."""

    def __init__(self) -> None:
        self.graphs: "OrderedDict[Tuple, _CapturedFit]" = OrderedDict()
        self.seen: "OrderedDict[Tuple, None]" = OrderedDict()
        self.eager: set = set()

    def __reduce__(self):
        return type(self), ()

    def __call__(self, key: Optional[Tuple], fit: Callable,
                 leaves: Sequence[torch.Tensor]) -> HMMVMPResult:
        if key is None:
            return fit(*leaves)
        captured = self.graphs.get(key)
        if captured is not None:
            self.graphs.move_to_end(key)
            return captured(leaves)
        if key in self.seen:
            del self.seen[key]
            try:
                captured = _CapturedFit(fit, leaves)
            except (RuntimeError, ValueError, TypeError):
                # What reads the card from the host cannot be captured; the
                # eager fit below raises again what is not the capture's.
                torch.cuda.synchronize(leaves[0].device)
                self.eager.add(key)
            else:
                _GRAPH["captures"] += 1
                self.graphs[key] = captured
                if len(self.graphs) > GRAPH_CAP:
                    self.graphs.popitem(last=False)
                return captured(leaves)
        elif key not in self.eager:
            self.seen[key] = None
            if len(self.seen) > GRAPH_CAP:
                self.seen.popitem(last=False)
        _GRAPH["eager"] += 1
        return fit(*leaves)
