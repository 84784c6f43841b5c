"""Plain reference of the discrete HMM configurations: a pooled Dirichlet
VMP fit of the transition and emission matrices, then a final smoothing pass
under the fitted posterior.

The algorithm is the one ``HMM.fit_vmp`` states: start from Dirichlet
posteriors ``prior + init_trans_diag * I`` and ``prior + init_emis_tilt *
[k mod M == m]``; each iteration runs forward-backward under ``exp(E[log
A])``, ``exp(E[log B])`` (digamma means) and the initial distribution, then
sets each posterior to its prior plus the expected counts, summed over every
replica; the ELBO is the summed log-evidence minus the Dirichlet KLs.
Here forward-backward is the scaled linear-space recursion.

Plain PyTorch, in float64 on the CPU for the judge.  ``precision="tf32"`` is
the control: float32 with every matrix product's operands rounded to TF32's
10-bit mantissa, as the card's tensor cores round them.  It imports nothing of
the program and takes nothing it made: only the observations and the
configuration.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.special import digamma, gammaln


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _matmul(precision: str) -> Callable:
    if precision == "tf32":
        return lambda a, b: torch.matmul(to_tf32(a), to_tf32(b))
    return torch.matmul


def mean_log(alpha: torch.Tensor) -> torch.Tensor:
    """E[log x] under Dirichlet(alpha), along the last axis."""
    return digamma(alpha) - digamma(alpha.sum(-1, keepdim=True))


def dirichlet_kl(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """KL(Dir(q) || Dir(p)) along the last axis."""
    q0, p0 = q.sum(-1), p.sum(-1)
    return (gammaln(q0) - gammaln(q).sum(-1) - gammaln(p0) + gammaln(p).sum(-1)
            + ((q - p) * (digamma(q) - digamma(q0)[..., None])).sum(-1))


def forward_backward(lik: torch.Tensor, A: torch.Tensor, pi: torch.Tensor, mm: Callable):
    """Scaled forward-backward over ``lik`` (R, T, K), weights ``A`` (K, K)
    (row: from-state) and ``pi`` (K,): state marginals (R, T, K), summed
    pairwise marginals (R, K, K) and log-evidence (R,)."""
    lt = lik.transpose(0, 1).contiguous()  # (T, R, K)
    T = lt.shape[0]
    alpha = torch.empty_like(lt)
    beta = torch.empty_like(lt)
    scale = torch.empty(lt.shape[:2], dtype=lt.dtype, device=lt.device)
    a = pi * lt[0]
    for t in range(T):
        if t:
            a = mm(a, A) * lt[t]
        scale[t] = a.sum(-1)
        a = a / scale[t][:, None]
        alpha[t] = a
    beta[T - 1] = 1.0
    for t in range(T - 2, -1, -1):
        beta[t] = mm(lt[t + 1] * beta[t + 1], A.t()) / scale[t + 1][:, None]
    gamma = alpha * beta
    w = lt[1:] * beta[1:] / scale[1:, :, None]  # (T-1, R, K)
    # sum_t alpha_t[j] w_t[k], a (K, K) product a replica
    pair = mm(alpha[:-1].permute(1, 2, 0), w.permute(1, 0, 2))
    return gamma.transpose(0, 1), A * pair, torch.log(scale).sum(0)


def fit(config: dict, obs: torch.Tensor, precision: str = "float64") -> Dict[str, torch.Tensor]:
    """The pooled VMP fit of ``config`` over ``obs`` (R, T) integer symbols,
    and its final smoothing pass, in ``precision`` on ``obs``'s device."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    mm = _matmul(precision)
    K, M = config["K"], config["M"]
    dev = obs.device
    R, T = obs.shape
    onehot = (obs[..., None] == torch.arange(M, device=dev)).to(dtype)  # (R, T, M)
    flat = onehot.reshape(R * T, M)
    pi = torch.full((K,), 1.0 / K, dtype=dtype, device=dev)
    trans_prior = torch.full((K, K), float(config["trans_prior"]), dtype=dtype, device=dev)
    emis_prior = torch.full((K, M), float(config["emis_prior"]), dtype=dtype, device=dev)
    eye = torch.eye(K, dtype=dtype, device=dev)
    tilt = ((torch.arange(K, device=dev) % M)[:, None] == torch.arange(M, device=dev)).to(dtype)
    trans = trans_prior + config["init_trans_diag"] * eye
    emis = emis_prior + config["init_emis_tilt"] * tilt

    def likelihoods(emis):
        return torch.exp(mm(flat, mean_log(emis).t())).reshape(R, T, K)

    elbo = None
    for _ in range(config["n_iterations"]):
        gamma, pair, log_z = forward_backward(
            likelihoods(emis), torch.exp(mean_log(trans)), pi, mm)
        trans = trans_prior + pair.sum(0)
        emis = emis_prior + mm(gamma.reshape(R * T, K).t(), flat)
        elbo = (log_z.sum() - dirichlet_kl(trans, trans_prior).sum()
                - dirichlet_kl(emis, emis_prior).sum())
    gamma, pair, log_z = forward_backward(likelihoods(emis), torch.exp(mean_log(trans)), pi, mm)
    return {"gamma": gamma, "xi_sum": pair, "log_evidence": log_z,
            "trans_alpha": trans, "emis_alpha": emis, "elbo": elbo}


def reference(config: dict, inputs: Dict[str, torch.Tensor],
              precision: str = "float64") -> Dict[str, torch.Tensor]:
    """The answers the program must give for ``inputs["obs"]``, computed in
    ``precision`` (``"float64"``, or ``"tf32"`` for the control)."""
    return fit(config, inputs["obs"], precision)


def _gap(got: torch.Tensor, want: torch.Tensor, scale) -> float:
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    got = torch.nan_to_num(got.to(torch.float64), nan=float("inf"))
    return float(((got - want.to(torch.float64)).abs() / scale).max())


def compare(config: dict, got: Dict[str, torch.Tensor],
            want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared, each at worst over its entries:

    - ``alpha_err``: the gap of a Dirichlet parameter (transitions and
      emissions), relative to the reference's;
    - ``elbo_err``: the gap of the ELBO, relative to the reference's;
    - ``gamma_err``: the gap of a final state marginal (a probability);
    - ``xi_err``: the gap of a final summed pairwise marginal, per step;
    - ``evidence_err``: the gap of a replica's final log-evidence, relative.

    The program may give the final posterior in log space (``log_gamma``,
    ``log_xi_sum``); results of another shape, or not finite, read infinite.
    """
    gamma = got["gamma"] if "gamma" in got else torch.exp(got["log_gamma"].to(torch.float64))
    xi = got["xi_sum"] if "xi_sum" in got else torch.exp(got["log_xi_sum"].to(torch.float64))
    T = want["gamma"].shape[1]
    w = {k: v.to(torch.float64) for k, v in want.items()}
    return {
        "alpha_err": max(_gap(got["trans_alpha"], w["trans_alpha"], w["trans_alpha"]),
                         _gap(got["emis_alpha"], w["emis_alpha"], w["emis_alpha"])),
        "elbo_err": _gap(got["elbo"], w["elbo"], w["elbo"].abs()),
        "gamma_err": _gap(gamma, w["gamma"], 1.0),
        "xi_err": _gap(xi, w["xi_sum"], max(T - 1, 1)),
        "evidence_err": _gap(got["log_evidence"], w["log_evidence"], w["log_evidence"].abs()),
    }
