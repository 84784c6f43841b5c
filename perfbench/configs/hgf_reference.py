"""Plain reference of the ``hgf`` configuration: the continuous-input
two-level hierarchical Gaussian filter (C. Mathys et al., "Uncertainty in
perception and the Hierarchical Gaussian Filter", Front. Hum. Neurosci.
8:825, 2014; first in Mathys et al., Front. Hum. Neurosci. 5:39, 2011) over
the rows of ``u`` (one replica a row), every replica from the zero state
(mu = 0, pi = 1), all at once.

Written from the paper's update equations, in its notation: the prediction
of both levels, the precision-weighted update of level 1 by the input of
precision ``pi_u``, the volatility prediction error ``delta1``, and the
update of level 2 by it.  Three guards depart from the paper, as the program
does, so that a long stream stays finite where the paper's filter (TAPAS)
stops on a negative precision: the log-volatility ``kappa * mu2 + omega`` is
clipped to ``+-max_log_nu``, the level-2 precision is floored at
``min_pi2``, and the level-2 step is clipped to ``+-max_mu2_step``.

Plain PyTorch, in float64 on the CPU for the judge; ``precision`` may name a
lower dtype, in which the same recursion is the control that a run in that
precision must fail.  It imports nothing of the program and takes nothing it
made: only the observations and the configuration.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

STATE = ("mu1", "pi1", "mu2", "pi2")
TRACKS = STATE + ("delta1",)


def _clip(x: torch.Tensor, bound: float) -> torch.Tensor:
    return torch.clamp(x, -bound, bound)


def hgf(u: torch.Tensor, config: dict,
        dtype: torch.dtype = torch.float64) -> Dict[str, torch.Tensor]:
    """Every step's posterior ``mu1, pi1, mu2, pi2`` and volatility
    prediction error ``delta1``, ``(n, T)`` each, and the final state
    (``<name>_final``, ``(n,)``), computed in ``dtype`` on ``u``'s device."""
    kappa, omega, theta = config["kappa"], config["omega"], config["theta"]
    pi_u = config["pi_u"]
    uT = u.to(dtype).t()  # (T, n): one row a step
    mu1 = torch.zeros_like(uT[0])
    pi1 = torch.ones_like(mu1)
    mu2, pi2 = torch.zeros_like(mu1), torch.ones_like(mu1)
    out = {name: torch.empty_like(uT) for name in TRACKS}
    for t in range(uT.shape[0]):
        # Prediction.  Level 1's step variance is its volatility,
        # exp(kappa * mu2 + omega); level 2's is theta.
        vol = torch.exp(_clip(kappa * mu2 + omega, config["max_log_nu"]))
        muhat1, pihat1 = mu1, 1.0 / (1.0 / pi1 + vol)
        muhat2, pihat2 = mu2, 1.0 / (1.0 / pi2 + theta)
        # Level 1: the input's prediction error, weighted by precisions.
        pi1 = pihat1 + pi_u
        mu1 = muhat1 + pi_u / pi1 * (uT[t] - muhat1)
        # The volatility prediction error.
        delta1 = (1.0 / pi1 + (mu1 - muhat1) ** 2) * pihat1 - 1.0
        # Level 2, with the weight of its prediction in level 1's.
        w1 = vol * pihat1
        pi2 = torch.clamp(pihat2 + 0.5 * kappa ** 2 * w1 * (w1 + (2.0 * w1 - 1.0) * delta1),
                          min=config["min_pi2"])
        mu2 = muhat2 + _clip(0.5 * kappa * w1 / pi2 * delta1, config["max_mu2_step"])
        for name, value in zip(TRACKS, (mu1, pi1, mu2, pi2, delta1)):
            out[name][t] = value
    result = {f"{name}_final": out[name][-1] for name in STATE}
    result.update((name, x.t()) for name, x in out.items())
    return result


def guard_fires(u: torch.Tensor, config: dict) -> Dict[str, int]:
    """How many replica-steps of the float64 recursion over ``u`` meet each
    guard: the log-volatility clipped, ``pi2`` floored, the ``mu2`` step
    clipped."""
    kappa, omega = config["kappa"], config["omega"]
    want = hgf(u, config)
    mu2_before = torch.cat([torch.zeros_like(want["mu2"][:, :1]), want["mu2"][:, :-1]], dim=1)
    return {"log_nu": int(((kappa * mu2_before + omega).abs() > config["max_log_nu"]).sum()),
            "pi2": int((want["pi2"] == config["min_pi2"]).sum()),
            "mu2_step": int(((want["mu2"] - mu2_before).abs()
                             >= config["max_mu2_step"] * (1 - 1e-12)).sum()),
            "steps": want["mu2"].numel()}


def reference(config: dict, inputs: Dict[str, torch.Tensor],
              precision: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The answers the program must give for ``inputs["u"]``, computed in
    float64, or in ``precision`` (``"bfloat16"`` for the control)."""
    dtype = torch.float64 if precision is None else getattr(torch, precision)
    return hgf(inputs["u"], config, dtype)


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x.to(torch.float64), nan=float("inf"))


def compare(config: dict, got: Dict[str, torch.Tensor],
            want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared, each at worst over every replica and step (and
    the final state):

    - ``mu_err``: the gap of ``mu1`` and of ``mu2``, in the reference's
      posterior standard deviations (``|gap| * sqrt(pi)``);
    - ``pi_err``: the gap of ``pi1`` and of ``pi2``, relative to the
      reference's;
    - ``delta1_err``: the absolute gap of ``delta1``.

    A result of another shape, or not finite, reads infinite.
    """
    def worst(names, scale):
        err = 0.0
        for name in names:
            g, w = got.get(name), want[name].to(torch.float64)
            if g is None or tuple(g.shape) != tuple(w.shape):
                return float("inf")
            err = max(err, float(((_finite(g) - w).abs() * scale(name)).max()))
        return err

    def pi_of(name):
        return want[name.replace("mu", "pi")].to(torch.float64)

    return {
        "mu_err": worst(("mu1", "mu2", "mu1_final", "mu2_final"), lambda n: pi_of(n).sqrt()),
        "pi_err": worst(("pi1", "pi2", "pi1_final", "pi2_final"), lambda n: 1.0 / pi_of(n)),
        "delta1_err": worst(("delta1",), lambda n: 1.0),
    }
