"""Plain reference of the scalar LGSSM configurations: a Kalman filter and
Rauch-Tung-Striebel smoother, with a flat prior on the first state, over the
rows of ``y`` (one replica a row).

Plain PyTorch, in float64 on the CPU for the judge; ``dtype`` and the device
of ``y`` are free so that the same code, in bfloat16, is the control that a
run in a lower precision must fail.  It imports nothing of the program and
takes nothing it made: only the observations and the configuration.
"""

from __future__ import annotations

from typing import Dict

import torch


def smooth(y: torch.Tensor, A: float, Q: float, H: float, R: float,
           dtype: torch.dtype = torch.float64) -> Dict[str, torch.Tensor]:
    """Smoothed ``mean`` and ``variance`` of every state, ``(n, T)`` each,
    computed in ``dtype`` on ``y``'s device."""
    yT = y.to(dtype).t().contiguous()  # (T, n): one row a step
    T, n = yT.shape
    one = torch.ones((), dtype=dtype, device=yT.device)
    fm = torch.empty_like(yT)
    fv = [one * (R / (H * H))]  # the variances do not depend on the data
    fm[0] = yT[0] / H
    for t in range(1, T):
        pm, pv = A * fm[t - 1], A * A * fv[t - 1] + Q
        gain = pv * H / (H * pv * H + R)
        fm[t] = pm + gain * (yT[t] - H * pm)
        fv.append(pv - gain * H * pv)
    sm = torch.empty_like(yT)
    sv = [None] * T
    sm[T - 1], sv[T - 1] = fm[T - 1], fv[T - 1]
    for t in range(T - 2, -1, -1):
        pv = A * A * fv[t] + Q
        gain = fv[t] * A / pv
        sm[t] = fm[t] + gain * (sm[t + 1] - A * fm[t])
        sv[t] = fv[t] + gain * gain * (sv[t + 1] - pv)
    var = torch.stack(sv)[:, None].expand(T, n)
    return {"mean": sm.t(), "variance": var.t()}


def reference(config: dict, inputs: Dict[str, torch.Tensor],
              precision: str = "float64") -> Dict[str, torch.Tensor]:
    """The answers the program must give for ``inputs["y"]``, computed in
    ``precision`` (``"float64"``, or ``"bfloat16"`` for the control)."""
    dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}[precision]
    return smooth(inputs["y"], config["A"], config["Q"], config["H"], config["R"], dtype)


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x.to(torch.float64), nan=float("inf"))


def compare(config: dict, got: Dict[str, torch.Tensor],
            want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared, each at worst over every replica and step:

    - ``mean_err``: the gap of a smoothed mean, in the reference's posterior
      standard deviations;
    - ``var_err``: the gap of a smoothed variance, relative to the reference's.

    A result of another shape, or not finite, reads infinite.
    """
    out = {}
    sd = want["variance"].to(torch.float64).sqrt()
    for name, key, scale in (("mean_err", "mean", sd),
                             ("var_err", "variance", want["variance"].to(torch.float64))):
        g, w = got[key], want[key].to(torch.float64)
        if tuple(g.shape) != tuple(w.shape):
            out[name] = float("inf")
            continue
        out[name] = float(((_finite(g) - w).abs() / scale).max())
    return out
