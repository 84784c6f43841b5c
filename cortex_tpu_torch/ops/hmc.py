"""Hamiltonian Monte Carlo over tree positions, many chains at once, in PyTorch.

The counterpart of ``cortex_tpu/ops/hmc.py``: leapfrog trajectories of a
fixed length, a warmup that adapts the step size by dual averaging
(Nesterov/Hoffman-Gelman) and a diagonal mass matrix from the warmup
trajectory (Welford), a short re-adaptation of the step size under that
mass, then sampling with both frozen.

The JAX package runs one chain and vmaps it over keys.  Here the chains are
a leading axis of the position, drawn from one ``torch.Generator``: each
chain keeps its own step size, mass and acceptance, as the vmap gives, and
``log_density`` stays a function of one position, differentiated by
``torch.func.vmap(torch.func.grad_and_value(...))`` over the chains: one
gradient and value a leapfrog position (JAX takes the gradient twice at
each inner position and the density once more at the end).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad_and_value, vmap

from ..utils.tree import as_float32_tensor, tree_flatten, tree_unflatten

__all__ = ["HMCResult", "hmc_sample"]


class HMCResult(NamedTuple):
    """``samples``: tree with a leading ``(n_samples,)`` axis (post-warmup),
    after the chain axis when there is one; ``log_density``:
    ``([n_chains,] n_samples)``; ``accept_rate``: mean post-warmup
    acceptance, one a chain; ``step_size``: the adapted value, one a
    chain."""

    samples: Any
    log_density: torch.Tensor
    accept_rate: torch.Tensor
    step_size: torch.Tensor


def _flatten(leaves, treedef, n_chains: int):
    """``(C, D)`` from position leaves that carry the chain axis first, and
    ``unflatten(x)`` from ``(..., D)`` back to a tree of that shape."""
    for leaf in leaves:
        if leaf.shape[:1] != (n_chains,):
            raise ValueError(f"a position leaf of shape {tuple(leaf.shape)} has no leading "
                             f"chain axis of {n_chains}")
    shapes = [tuple(leaf.shape[1:]) for leaf in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([leaf.reshape(n_chains, -1) for leaf in leaves], dim=-1)

    def unflatten(x):
        out = [part.reshape(x.shape[:-1] + s)
               for part, s in zip(torch.split(x, sizes, dim=-1), shapes)]
        return tree_unflatten(treedef, out)

    return flat, unflatten


def hmc_sample(
    generator: torch.Generator,
    log_density: Callable,
    init_position: Any,
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_leapfrog: int = 32,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    *,
    n_chains: Optional[int] = None,
) -> HMCResult:
    """Sample from ``exp(log_density(position))``; ``position`` is any tree
    of float tensors.  Returns post-warmup draws.

    With ``n_chains=None`` one chain runs from ``init_position``.  With
    ``n_chains=C``, every leaf of ``init_position`` carries a leading chain
    axis of ``C``, and the result carries it too (``samples`` leaves
    ``(C, n_samples, ...)``, ``log_density`` ``(C, n_samples)``,
    ``accept_rate`` and ``step_size`` ``(C,)``).  ``log_density`` takes one
    position.  All draws come from ``generator``, on its device.
    """
    single = n_chains is None
    C = 1 if single else n_chains
    leaves, treedef = tree_flatten(init_position)
    leaves = [as_float32_tensor(v, generator.device) for v in leaves]
    x, unflatten = _flatten([v[None] for v in leaves] if single else leaves, treedef, C)
    dev, dtype = x.device, x.dtype
    d = x.shape[-1]

    def logp(flat):
        return torch.as_tensor(log_density(unflatten(flat)))

    grad_and_logp = vmap(grad_and_value(logp))

    def uniform(shape=(C,)):
        return torch.rand(shape, generator=generator, dtype=dtype, device=dev)

    def leapfrog(x, p, eps, inv_mass):
        eps = eps[:, None]
        g, lp = grad_and_logp(x)
        for _ in range(n_leapfrog):
            p = p + 0.5 * eps * g
            x = x + eps * inv_mass * p
            g, lp = grad_and_logp(x)
            p = p + 0.5 * eps * g
        return x, p, lp

    def kinetic(p, inv_mass):
        return 0.5 * torch.sum(p * p * inv_mass, dim=-1)

    def hmc_step(x, lp, eps, inv_mass, sqrt_mass):
        # Jitter the step size ±20% per iteration: fixed-length trajectories
        # on near-Gaussian targets resonate with the period and produce
        # strongly antithetic chains otherwise.
        eps = eps * (0.8 + 0.4 * uniform())
        p0 = sqrt_mass * torch.randn((C, d), generator=generator, dtype=dtype, device=dev)
        x_new, p_new, lp_new = leapfrog(x, p0, eps, inv_mass)
        log_alpha = (lp_new - kinetic(p_new, inv_mass)) - (lp - kinetic(p0, inv_mass))
        log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
        accept = torch.log(uniform()) < log_alpha
        x = torch.where(accept[:, None], x_new, x)
        lp = torch.where(accept, lp_new, lp)
        return x, lp, torch.clamp(torch.exp(log_alpha), max=1.0)

    gamma, t0, kappa = 0.05, 10.0, 0.75

    def dual_average(mu, h_bar, log_eps_bar, alpha, t):
        h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (target_accept - alpha) / (t + t0)
        log_eps = mu - math.sqrt(t) / gamma * h_bar
        w = t ** (-kappa)
        return log_eps, w * log_eps + (1.0 - w) * log_eps_bar, h_bar

    # --- Warmup: dual-averaging step size + Welford diagonal mass. ---
    mu = math.log(10.0 * init_step_size)
    lp = vmap(logp)(x)
    log_eps = torch.full((C,), math.log(init_step_size), dtype=dtype, device=dev)
    log_eps_bar, h_bar = log_eps.clone(), torch.zeros_like(log_eps)
    mean, m2 = torch.zeros((C, d), dtype=dtype, device=dev), torch.zeros((C, d), dtype=dtype,
                                                                          device=dev)
    ones = torch.ones(d, dtype=dtype, device=dev)
    t = 1.0
    for _ in range(n_warmup):
        x, lp, alpha = hmc_step(x, lp, torch.exp(log_eps), ones, ones)
        log_eps, log_eps_bar, h_bar = dual_average(mu, h_bar, log_eps_bar, alpha, t)
        # Welford running moments of the position (for the diagonal mass).
        delta = x - mean
        mean = mean + delta / t
        m2 = m2 + delta * (x - mean)
        t += 1.0
    var = m2 / max(t - 2.0, 1.0)
    inv_mass = torch.clamp(var, min=1e-6)  # mass ≈ inverse posterior variance
    sqrt_mass = 1.0 / torch.sqrt(inv_mass)
    eps = torch.exp(log_eps_bar)

    # Short re-adaptation under the final mass matrix.
    log_eps = torch.log(eps)
    log_eps_bar, h_bar = log_eps.clone(), torch.zeros_like(log_eps)
    mu = torch.log(eps * 10.0)
    t = 1.0
    for _ in range(max(1, n_warmup // 4)):
        x, lp, alpha = hmc_step(x, lp, torch.exp(log_eps), inv_mass, sqrt_mass)
        log_eps, log_eps_bar, h_bar = dual_average(mu, h_bar, log_eps_bar, alpha, t)
        t += 1.0
    eps = torch.exp(log_eps_bar)

    # --- Sampling with frozen (eps, mass). ---
    xs, lps, alphas = [], [], []
    for _ in range(n_samples):
        x, lp, alpha = hmc_step(x, lp, eps, inv_mass, sqrt_mass)
        xs.append(x)
        lps.append(lp)
        alphas.append(alpha)
    xs = torch.stack(xs, dim=1)  # (C, n_samples, D)
    result = HMCResult(unflatten(xs), torch.stack(lps, dim=1),
                       torch.stack(alphas, dim=1).mean(dim=1), eps)
    if single:
        return HMCResult(*(_drop_chain_axis(v) for v in result))
    return result


def _drop_chain_axis(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [leaf[0] for leaf in leaves])
