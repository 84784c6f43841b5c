"""Scalar-chain message passing in PyTorch, and its hand-written CUDA kernel."""

from .chains import (
    ChainMarginals,
    lgssm_messages_scan,
    lgssm_smooth_assoc,
    lgssm_smooth_matmul,
    lgssm_smooth_scan,
    lgssm_smoother_operator,
    scalar_kalman_update,
)
from .kernels import lgssm_smooth_fused, lgssm_smooth_fused_reference

__all__ = [
    "ChainMarginals",
    "lgssm_smooth_scan",
    "lgssm_smooth_assoc",
    "lgssm_smooth_matmul",
    "lgssm_smoother_operator",
    "lgssm_messages_scan",
    "scalar_kalman_update",
    "lgssm_smooth_fused",
    "lgssm_smooth_fused_reference",
]
