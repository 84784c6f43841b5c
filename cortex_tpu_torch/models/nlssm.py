"""Nonlinear Gaussian state-space model with projected-Gaussian sweeps, in PyTorch.

The counterpart of ``cortex_tpu/models/nlssm.py``: user dynamics ``f`` and
observations ``h`` with EKF (autodiff linearization) or UKF (sigma-point)
message projection.  Same API shape as :class:`~cortex_tpu_torch.models.LGSSM`
(``filter``/``smooth``/``log_evidence``/``sample``), replica-batched over
leading axes and differentiable through ``log_evidence``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
from torch.func import vmap

from ..ops.nonlinear import (
    NLSSMBeliefs,
    ekf_filter,
    ekf_smooth,
    ukf_filter,
    ukf_smooth,
)
from ..utils.tree import to_tensor

__all__ = ["NonlinearSSM", "NLSSMBeliefs"]


@dataclasses.dataclass(frozen=True)
class NonlinearSSM:
    """``x_1 ~ N(m0, P0)``, ``x_t = f(x_{t-1}) + N(0, Q)``,
    ``y_t = h(x_t) + N(0, R)`` with ``x ∈ R^d``, ``y ∈ R^m``.

    ``f: (d,) -> (d,)`` and ``h: (d,) -> (m,)`` are plain torch functions of
    one state; the ops layer batches them with ``torch.func.vmap``, so the
    same callables serve 1 or 100k chains.  ``Q``, ``R``, ``m0`` and ``P0``
    are tensors (or arrays, taken to ``y``'s device and dtype).
    """

    f: Callable[[torch.Tensor], torch.Tensor]
    h: Callable[[torch.Tensor], torch.Tensor]
    Q: torch.Tensor
    R: torch.Tensor
    m0: torch.Tensor
    P0: torch.Tensor

    def _args(self, y):
        return (self.f, self.h, self.Q, self.R, y, self.m0, self.P0)

    def filter(self, y: torch.Tensor, method: str = "ukf", **kw) -> NLSSMBeliefs:
        """Filtered beliefs p(x_t | y_{1:t}); ``y`` shaped ``(..., T, m)``.
        Keyword options (``alpha``/``beta``/``kappa``/``jitter``) apply to
        the UKF only."""
        if method == "ekf":
            if kw:
                raise TypeError(f"ekf takes no options, got {sorted(kw)}")
            return ekf_filter(*self._args(y))
        if method == "ukf":
            return ukf_filter(*self._args(y), **kw)
        raise ValueError(f"Unknown method: {method!r}")

    def smooth(self, y: torch.Tensor, method: str = "ukf", **kw) -> NLSSMBeliefs:
        """Smoothed beliefs p(x_t | y_{1:T}) via the extended/unscented RTS
        backward sweep."""
        if method == "ekf":
            if kw:
                raise TypeError(f"ekf takes no options, got {sorted(kw)}")
            return ekf_smooth(*self._args(y))
        if method == "ukf":
            return ukf_smooth(*self._args(y), **kw)
        raise ValueError(f"Unknown method: {method!r}")

    def log_evidence(self, y: torch.Tensor, method: str = "ukf", **kw) -> torch.Tensor:
        """Approximate log p(y_{1:T}) from the one-step prediction errors,
        shape ``y.shape[:-2]`` (one value per replica)."""
        return self.filter(y, method=method, **kw).loglik

    def sample(
        self, generator: torch.Generator, T: int, batch_shape: Tuple[int, ...] = ()
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Simulate ``(x, y)``, shapes ``batch_shape + (T, d/m)``, drawing from
        ``generator`` on its device (the model's arrays are taken there)."""
        dev = generator.device
        dtype = self.Q.dtype if isinstance(self.Q, torch.Tensor) else torch.float32
        Q, R, m0, P0 = (to_tensor(a, dtype=dtype, device=dev)
                        for a in (self.Q, self.R, self.m0, self.P0))
        d, m = Q.shape[-1], R.shape[-1]
        LQ, LR, LP0 = (torch.linalg.cholesky(a) for a in (Q, R, P0))
        batch_shape = tuple(batch_shape)
        n = 1
        for s in batch_shape:
            n *= s

        def normal(shape):
            return torch.randn(shape, generator=generator, dtype=dtype, device=dev)

        x = m0 + normal((n, d)) @ LP0.T
        wn = normal((T - 1, n, d))
        vn = normal((T, n, m))
        f_b, h_b = vmap(self.f), vmap(self.h)
        xs = [x]
        for noise in wn:
            x = f_b(x) + noise @ LQ.T
            xs.append(x)
        xs = torch.stack(xs)  # (T, n, d)
        ys = vmap(h_b)(xs) + vn @ LR.T
        return (xs.movedim(0, -2).reshape(batch_shape + (T, d)),
                ys.movedim(0, -2).reshape(batch_shape + (T, m)))
