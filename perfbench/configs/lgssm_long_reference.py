"""Plain reference of the ``lgssm-long`` configuration: a Kalman filter and
Rauch-Tung-Striebel smoother of the whole chain, with a flat prior on the
first state, over the rows of ``y`` (one replica a row), one step after the
other from the first to the last and back.

Plain PyTorch, in float64 on the CPU for the judge; ``precision`` names the
dtype of every number it computes, so that the same code in bfloat16 is the
control that a run in a lower precision must fail, and in float32 the
sequential smoother that the program's float32 error is held against.  It
imports nothing of the program and takes nothing it made: only the
observations and the configuration.

Lean in host memory and time at 10,000 x 65,536: the means live in one
``(T, n)`` buffer of rows, filtered and then smoothed in place, one row
operation a step; the variances and gains, which with a flat prior do not
depend on the data, are one scalar a step, computed once for each
``(T, A, Q, H, R, precision)``.  Every ``(n, T)`` tensor is read through its
``(T, n)`` view, in ``STEPS`` rows at a time: a tensor laid out time-major
(a transposed view, as the four-card entry hands its inputs and answers
over) is read in the order it lies in memory.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
# Steps a slice when answers are compared: a (STEPS, n) float64 temporary,
# 20 MB at n = 10,000.
STEPS = 256


@functools.lru_cache(maxsize=4)
def coefficients(T: int, A: float, Q: float, H: float, R: float,
                 precision: str = "float64") -> Tuple[List[float], torch.Tensor, torch.Tensor,
                                                        List[float], torch.Tensor]:
    """The scalars of every step, each computed in ``precision``: the filter's
    weights ``(keep, gain)`` (``m_t = keep_t m_{t-1} + gain_t y_t``), the
    smoother's ``(stay, back)`` (``s_t = stay_t m_t + back_t s_{t+1}``;
    ``stay`` is 1 at the last step) and the smoothed variances ``(T,)``.
    ``gain`` and ``stay`` are ``(T, 1)`` columns, which scale every row of
    means at once."""
    dtype = DTYPES[precision]

    def c(x):
        return torch.tensor(x, dtype=dtype)

    if dtype == torch.float64:
        c = float  # Python's floats are IEEE doubles: the same numbers, far sooner
    A_, Q_, H_, R_ = c(A), c(Q), c(H), c(R)
    fv = [R_ / (H_ * H_)]
    keep, gain = [c(0.0)], [1 / H_]
    for _ in range(1, T):
        pv = A_ * A_ * fv[-1] + Q_
        k = pv * H_ / (H_ * pv * H_ + R_)
        keep.append(A_ * (1 - k * H_))
        gain.append(k)
        fv.append(pv - k * H_ * pv)
    sv = [None] * T
    sv[T - 1] = fv[T - 1]
    stay, back = [1.0] * T, [0.0] * T
    for t in range(T - 2, -1, -1):
        pv = A_ * A_ * fv[t] + Q_
        g = fv[t] * A_ / pv
        stay[t], back[t] = float(1 - g * A_), float(g)
        sv[t] = fv[t] + g * g * (sv[t + 1] - pv)

    def column(values):
        return torch.tensor([float(v) for v in values], dtype=dtype)[:, None]

    return ([float(k) for k in keep], column(gain), column(stay), back,
            torch.tensor([float(v) for v in sv], dtype=dtype))


def smooth(y: torch.Tensor, A: float, Q: float, H: float, R: float,
           precision: str = "float64") -> Dict[str, torch.Tensor]:
    """Smoothed ``mean`` and ``variance`` of every state, ``(n, T)`` each,
    computed in ``precision`` on ``y``'s device; both are views, the means
    of one ``(T, n)`` buffer and the variances of one ``(T,)`` row."""
    dtype = DTYPES[precision]
    n, T = y.shape
    keep, gain, stay, back, var = coefficients(T, float(A), float(Q), float(H), float(R),
                                               precision)
    m = torch.empty((T, n), dtype=dtype, device=y.device)  # one row a step
    m.copy_(y.t()).mul_(gain.to(y.device))
    for t in range(1, T):
        m[t].add_(m[t - 1], alpha=keep[t])
    m.mul_(stay.to(y.device))
    for t in range(T - 2, -1, -1):
        m[t].add_(m[t + 1], alpha=back[t])
    var = var.to(y.device)
    return {"mean": m.t(), "variance": var[None, :].expand(n, T)}


def reference(config: dict, inputs: Dict[str, torch.Tensor],
              precision: str = "float64") -> Dict[str, torch.Tensor]:
    """The answers the program must give for ``inputs["y"]``, computed in
    ``precision`` (``"float64"``; ``"bfloat16"`` for the control;
    ``"float32"`` for the sequential smoother in the program's precision)."""
    return smooth(inputs["y"], config["A"], config["Q"], config["H"], config["R"], precision)


def compare(config: dict, got: Dict[str, torch.Tensor],
            want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared, each at worst over every replica and step:

    - ``mean_err``: the gap of a smoothed mean, in the reference's posterior
      standard deviations;
    - ``var_err``: the gap of a smoothed variance, relative to the reference's.

    Each is read a slice of ``STEPS`` steps at a time, through the ``(T, n)``
    views; a result of another shape, or not finite, reads infinite.
    """
    out = {}
    var = want["variance"][0].to(torch.float64)
    for name, key, scale in (("mean_err", "mean", var.sqrt()), ("var_err", "variance", var)):
        g, w = got[key], want[key]
        if tuple(g.shape) != tuple(w.shape):
            out[name] = float("inf")
            continue
        worst = _worst_gaps(g.t(), w.t())
        out[name] = float((worst.nan_to_num_(nan=float("inf")) / scale).max())
    return out


def _worst_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each step's largest ``|got - want|`` over the replicas, in float64, of
    two ``(T, n)`` tensors; NaN stays NaN."""
    T, n = want.shape
    worst = torch.empty(T, dtype=torch.float64)
    gap = torch.empty((min(STEPS, T), n), dtype=torch.float64)
    for t0 in range(0, T, STEPS):
        part = gap[:min(STEPS, T - t0)]
        part.copy_(got[t0:t0 + STEPS]).sub_(want[t0:t0 + STEPS])
        low, high = torch.aminmax(part, dim=1)
        torch.maximum(high, low.neg_(), out=worst[t0:t0 + STEPS])
    return worst
