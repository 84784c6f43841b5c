"""Linear Gaussian state-space model, in PyTorch.

The counterpart of ``cortex_tpu/models/lgssm.py``: BP smoothing whose
marginals are Kalman/RTS-equivalent, with replicas (independent chains)
along the leading axes of ``y``.  Three interchangeable smoothers with
identical marginals:

- ``method="scan"``: sequential in time, batched over replicas,
- ``method="matmul"``: the smoother as one affine map (dense data only),
- ``method="assoc"``: time-parallel associative scan, O(log T) depth.

The fused CUDA sweep is the op :func:`cortex_tpu_torch.ops.lgssm_smooth_fused`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.chains import (
    ChainMarginals,
    lgssm_smooth_assoc,
    lgssm_smooth_matmul,
    lgssm_smooth_scan,
    scalar_kalman_update,
)

__all__ = ["LGSSM"]

_SMOOTHERS = {
    "scan": lgssm_smooth_scan,
    "assoc": lgssm_smooth_assoc,
    "matmul": lgssm_smooth_matmul,
}


class LGSSM(nn.Module):
    """Scalar-state linear Gaussian SSM: ``x_t = A x_{t-1} + N(0,Q)``,
    ``y_t = H x_t + N(0,R)``.

    A, Q, H and R are Python floats, as in the JAX model; the module holds no
    tensors, so it works on whatever device ``y`` lies on.  Calling the
    module smooths.
    """

    def __init__(self, A: float = 1.0, Q: float = 1.0, H: float = 1.0, R: float = 1.0):
        super().__init__()
        self.A, self.Q, self.H, self.R = float(A), float(Q), float(H), float(R)

    def extra_repr(self) -> str:
        return f"A={self.A}, Q={self.Q}, H={self.H}, R={self.R}"

    def forward(self, y, prior=None, method: str = "scan") -> ChainMarginals:
        """Same as :meth:`smooth`."""
        return self.smooth(y, prior, method)

    def smooth(
        self,
        y: torch.Tensor,
        prior: Optional[Tuple[object, object]] = None,
        method: str = "scan",
    ) -> ChainMarginals:
        """Posterior marginals of all states given all observations.

        NaN entries in ``y`` are missing observations (``"scan"`` and
        ``"assoc"``); a missing ``y[..., 0]`` needs an explicit ``prior``.
        """
        if method not in _SMOOTHERS:
            raise ValueError(f"Unknown method: {method!r}")
        return _SMOOTHERS[method](y, self.A, self.Q, self.H, self.R, prior)

    def filter(
        self,
        y: torch.Tensor,
        prior: Optional[Tuple[object, object]] = None,
    ) -> ChainMarginals:
        """Filtered beliefs p(x_t | y_{1:t}) by a forward pass.  NaN
        observations carry zero information (a pure prediction step)."""
        observed = ~torch.isnan(y)
        yT = torch.where(observed, y, 0.0).movedim(-1, 0)
        obsT = observed.movedim(-1, 0)
        A, Q, H, R = self.A, self.Q, self.H, self.R

        xi_obs = H * yT / R
        w_obs = obsT.to(y.dtype) * (H * H / R)
        xi = torch.empty_like(xi_obs)
        w = torch.empty_like(w_obs)
        if prior is not None:
            pm, pv = prior
            xi[0], w[0] = xi_obs[0] + pm / pv, w_obs[0] + 1.0 / pv
        else:
            xi[0], w[0] = xi_obs[0], w_obs[0]
        for t in range(1, yT.shape[0]):
            # Division-safe rational projection (valid at w = 0).
            denom = A * A + Q * w[t - 1]
            xi[t] = A * xi[t - 1] / denom + xi_obs[t]
            w[t] = w[t - 1] / denom + w_obs[t]
        return ChainMarginals(
            (xi / w).movedim(0, -1).contiguous(), (1.0 / w).movedim(0, -1).contiguous()
        )

    def log_evidence(
        self,
        y: torch.Tensor,
        prior: Tuple[object, object] = (0.0, 1.0),
    ) -> torch.Tensor:
        """log p(y_{1:T}) by the prediction-error decomposition, shape
        ``y.shape[:-1]``.  NaN observations are marginalized out: they add no
        log-likelihood and skip the measurement update."""
        observed = ~torch.isnan(y)
        yT = torch.where(observed, y, 0.0).movedim(-1, 0)
        obsT = observed.movedim(-1, 0)
        A, Q, H, R = self.A, self.Q, self.H, self.R
        batch = yT.shape[1:]
        m = torch.as_tensor(prior[0], dtype=y.dtype, device=y.device).expand(batch)
        v = torch.as_tensor(prior[1], dtype=y.dtype, device=y.device).expand(batch)
        total = torch.zeros(batch, dtype=y.dtype, device=y.device)
        for t in range(yT.shape[0]):
            m_u, v_u, ll = scalar_kalman_update(yT[t], m, v, H, R)
            total = total + torch.where(obsT[t], ll, 0.0)
            m_f = torch.where(obsT[t], m_u, m)
            v_f = torch.where(obsT[t], v_u, v)
            m, v = A * m_f, A * A * v_f + Q
        return total

    def sample(
        self,
        generator: torch.Generator,
        T: int,
        batch_shape: Tuple[int, ...] = (),
        x0: float = 0.0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Simulate ``(x, y)`` trajectories of length T, shape
        ``batch_shape + (T,)``, float32, on the generator's device."""
        shape = (T,) + tuple(batch_shape)
        device = generator.device
        wn = torch.randn(shape, generator=generator, device=device)
        vn = torch.randn(shape, generator=generator, device=device)
        xs = torch.empty_like(wn)
        x = torch.full(shape[1:], float(x0), device=device)
        for t in range(T):
            x = self.A * x + self.Q ** 0.5 * wn[t]
            xs[t] = x
        ys = self.H * xs + self.R ** 0.5 * vn
        return xs.movedim(0, -1).contiguous(), ys.movedim(0, -1).contiguous()
