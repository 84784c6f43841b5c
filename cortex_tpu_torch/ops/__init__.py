"""Message passing on chains in PyTorch, and the port's hand-written CUDA kernels."""

from .chains import (
    ChainMarginals,
    lgssm_messages_scan,
    lgssm_smooth_assoc,
    lgssm_smooth_matmul,
    lgssm_smooth_scan,
    lgssm_smoother_operator,
    scalar_kalman_update,
)
from .hmm import HMMPosterior, hmm_forward_backward, hmm_viterbi
from .kernels import lgssm_smooth_fused, lgssm_smooth_fused_reference
from .kernels_hgf import ALL_TRACKS, hgf_filter_fused, hgf_filter_fused_reference, hgf_update
from .kernels_hmm import (
    hmm_forward_backward_counts_fused,
    hmm_forward_backward_counts_fused_reference,
    hmm_forward_backward_fused,
    hmm_forward_backward_fused_reference,
)

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
    "HMMPosterior",
    "hmm_forward_backward",
    "hmm_viterbi",
    "hmm_forward_backward_fused",
    "hmm_forward_backward_fused_reference",
    "hmm_forward_backward_counts_fused",
    "hmm_forward_backward_counts_fused_reference",
    "ALL_TRACKS",
    "hgf_update",
    "hgf_filter_fused",
    "hgf_filter_fused_reference",
]
