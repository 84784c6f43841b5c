"""Vector-state LGSSM model wrapper (multivariate Kalman smoothing), in PyTorch.

The counterpart of ``cortex_tpu/models/mv_lgssm.py``: the d-dimensional
counterpart of :class:`cortex_tpu_torch.models.LGSSM`, over the smoothers of
:mod:`cortex_tpu_torch.ops.chains_mv` and
:mod:`cortex_tpu_torch.ops.sqrt_kalman`.  The model holds Python floats, so
every method runs on the device (and in the dtype) of its ``y``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..dists.gaussian import _cholesky_nan
from ..ops.chains_mv import (
    MvChainMarginals,
    _observations,
    mv_lgssm_filter,
    mv_lgssm_log_evidence,
    mv_lgssm_smooth,
    mv_lgssm_smooth_blocked,
    mv_lgssm_smooth_matmul,
    mv_lgssm_smooth_seq,
)
from ..ops.sqrt_kalman import sqrt_lgssm_smooth
from ..utils.tree import as_float32_tensor

__all__ = ["MvLGSSM"]

_METHODS = ("auto", "blocked", "assoc", "scan", "matmul", "sqrt")


def _has_partial_missing(y: torch.Tensor) -> bool:
    """True iff ``y`` has a step with some but not all components NaN — the
    case the shared-element builders cannot express."""
    nan = torch.isnan(y)
    return bool((nan.any(dim=-1) & ~nan.all(dim=-1)).any())


@dataclasses.dataclass(frozen=True)
class MvLGSSM:
    """``x_t = A x_{t-1} + N(0, Q)``, ``y_t = H x_t + N(0, R)`` with
    ``A, Q: (d, d)``, ``H: (m, d)``, ``R: (m, m)``.

    Arrays are held as tuples of tuples, as in the JAX model (so
    ``dataclasses.asdict`` of one builds the other); use
    :meth:`from_arrays`.
    """

    A: tuple
    Q: tuple
    H: tuple
    R: tuple
    m0: tuple
    P0: tuple

    @classmethod
    def from_arrays(cls, A, Q, H, R, m0, P0) -> "MvLGSSM":
        """The model from arrays, tensors or nested lists.  Python and numpy
        floats are rounded to float32, as ``jnp.asarray`` makes them."""

        def t(a):
            a = as_float32_tensor(a)
            if a.ndim > 1:
                return tuple(map(tuple, a.tolist()))
            return tuple(a.tolist())

        return cls(t(A), t(Q), t(H), t(R), t(m0), t(P0))

    @property
    def dim(self) -> int:
        return len(self.A)

    def auto_method(self) -> str:
        """The smoothing path :meth:`smooth` selects for ``method="auto"``:
        "blocked" for d ≤ 8, "scan" above (the JAX package's crossover,
        measured on its own hardware)."""
        return "blocked" if self.dim <= 8 else "scan"

    def _args(self, y):
        """The chains' arguments; ``y`` that is not a tensor becomes float32
        on the card (the model holds numbers, not tensors)."""
        return (_observations(y), self.A, self.Q, self.H, self.R, (self.m0, self.P0))

    def smooth(
        self, y: torch.Tensor, method: str = "auto", missing: str = "auto"
    ) -> MvChainMarginals:
        """Posterior marginals; ``y``: ``(..., T, m)``.

        ``method``: ``"auto"`` (:meth:`auto_method`), ``"blocked"`` (the
        two-level blocked scan), ``"scan"`` (sequential filter + RTS),
        ``"assoc"`` (flat associative scan), ``"matmul"`` (the precomputed
        affine operator; dense data only) or ``"sqrt"`` (the QR-factored
        square-root smoother).

        ``missing`` controls the NaN granularity: ``"component"`` masks
        individual observation components, ``"step"`` degrades the whole
        step on the blocked/assoc builders, ``"auto"`` (default) inspects
        ``y`` and takes "component" iff some step is partially observed.
        The "scan" path always masks per component, so it refuses an
        explicit ``missing="step"``.
        """
        if method == "auto":
            method = self.auto_method()
        if missing not in ("auto", "step", "component"):
            raise ValueError(
                f"unknown missing={missing!r}; expected 'auto', 'step', or 'component'"
            )
        if method not in _METHODS:
            raise ValueError(
                f"unknown method {method!r}; expected 'auto', 'blocked', "
                "'assoc', 'scan', 'matmul', or 'sqrt'"
            )
        if method == "scan" and missing == "step":
            raise ValueError(
                "method='scan' masks NaNs per component; missing='step' applies to "
                "'blocked' and 'assoc' only"
            )
        args = self._args(y)
        if missing == "auto":
            missing = "component" if _has_partial_missing(args[0]) else "step"
        component = missing == "component"
        if method == "assoc":
            return mv_lgssm_smooth(*args, component_missing=component)
        if method == "blocked":
            return mv_lgssm_smooth_blocked(*args, component_missing=component)
        if method == "scan":
            return mv_lgssm_smooth_seq(*args)
        if method == "matmul":
            if component:
                raise ValueError(
                    "method='matmul' requires dense data (the precomputed "
                    "affine operator assumes every component observed); "
                    "use 'scan' or 'blocked' for per-component gaps"
                )
            return mv_lgssm_smooth_matmul(*args)
        if component:
            raise ValueError(
                "method='sqrt' masks whole steps only; use 'scan' or "
                "'blocked' for per-component gaps"
            )
        return sqrt_lgssm_smooth(*args)

    def filter(self, y: torch.Tensor) -> MvChainMarginals:
        """Filtered beliefs p(x_t | y_{1:t}); ``y``: ``(..., T, m)``.  NaNs
        are masked per component; fully-NaN steps predict through the gap."""
        return mv_lgssm_filter(*self._args(y))

    def log_evidence(self, y: torch.Tensor) -> torch.Tensor:
        """log p(y_{1:T}) per replica by the prediction-error decomposition;
        NaN components are marginalized analytically, per component."""
        return mv_lgssm_log_evidence(*self._args(y))

    def sample(
        self, key: torch.Generator, T: int, batch_shape: Tuple[int, ...] = ()
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Simulate ``(x, y)`` of shapes ``batch_shape + (T, d)`` and
        ``batch_shape + (T, m)``, float32, on the generator's device."""
        opts = dict(dtype=torch.float32, device=key.device)
        A, Q, H, R, m0, P0 = (torch.tensor(a, **opts)
                              for a in (self.A, self.Q, self.H, self.R, self.m0, self.P0))
        d, m = A.shape[0], H.shape[0]
        batch = tuple(batch_shape)
        Lq, Lr, L0 = (_cholesky_nan(M) for M in (Q, R, P0))
        x0 = torch.randn(batch + (d,), generator=key, **opts)
        x = m0 + torch.einsum("ij,...j->...i", L0, x0)
        wn = torch.randn((T,) + batch + (d,), generator=key, **opts)
        vn = torch.randn((T,) + batch + (m,), generator=key, **opts)
        xs = []
        for noise in wn:
            x = torch.einsum("ij,...j->...i", A, x) + torch.einsum("ij,...j->...i", Lq, noise)
            xs.append(x)
        xs = torch.stack(xs) if xs else torch.zeros_like(wn)
        ys = torch.einsum("ij,t...j->t...i", H, xs) + torch.einsum("ij,t...j->t...i", Lr, vn)
        return xs.movedim(0, -2).contiguous(), ys.movedim(0, -2).contiguous()
