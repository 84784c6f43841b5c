"""Message passing on chains in PyTorch (scalar and vector states, square-root
and robust smoothers, free energies, nonlinear sweeps), loopy GaBP, EP, CVI and
HMC, and the port's hand-written CUDA kernels."""

from ..utils import spans as _spans

# The subpackage's imports: a set-up span of the process.
with _spans.setup_span("setup.import"):
    from .chains import (
        ChainMarginals,
        lgssm_messages_scan,
        lgssm_smooth_assoc,
        lgssm_smooth_matmul,
        lgssm_smooth_scan,
        lgssm_smoother_operator,
        scalar_kalman_update,
    )
    from .chains_mv import (
        MvChainMarginals,
        mv_lgssm_filter,
        mv_lgssm_log_evidence,
        mv_lgssm_smooth,
        mv_lgssm_smooth_blocked,
    )
    from .hmm import HMMPosterior, hmm_forward_backward, hmm_viterbi
    from .cvi import CVIResult, cvi_linear_model
    from .ep import EPResult, ep_linear_model, gauss_hermite_tilted, probit_tilted_moments
    from .gabp import GaBPResult, gabp_grid_solve, gabp_solve, grid_edges
    from .hmc import HMCResult, hmc_sample
    from .nonlinear import NLSSMBeliefs, ekf_filter, ekf_smooth, ukf_filter, ukf_smooth
    from .kernels import lgssm_smooth_fused, lgssm_smooth_fused_reference
    from .kernels_hgf import ALL_TRACKS, hgf_filter_fused, hgf_filter_fused_reference, hgf_update
    from .robust import RobustChainResult, robust_lgssm_smooth
    from .sqrt_kalman import SqrtFilterBeliefs, sqrt_lgssm_filter, sqrt_lgssm_smooth
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
    "MvChainMarginals",
    "mv_lgssm_smooth",
    "mv_lgssm_smooth_blocked",
    "mv_lgssm_filter",
    "mv_lgssm_log_evidence",
    "SqrtFilterBeliefs",
    "sqrt_lgssm_filter",
    "sqrt_lgssm_smooth",
    "RobustChainResult",
    "robust_lgssm_smooth",
    "lgssm_smooth_fused",
    "lgssm_smooth_fused_reference",
    "HMMPosterior",
    "hmm_forward_backward",
    "hmm_viterbi",
    "GaBPResult",
    "gabp_solve",
    "gabp_grid_solve",
    "HMCResult",
    "hmc_sample",
    "grid_edges",
    "CVIResult",
    "cvi_linear_model",
    "EPResult",
    "ep_linear_model",
    "probit_tilted_moments",
    "gauss_hermite_tilted",
    "NLSSMBeliefs",
    "ekf_filter",
    "ekf_smooth",
    "ukf_filter",
    "ukf_smooth",
    "hmm_forward_backward_fused",
    "hmm_forward_backward_fused_reference",
    "hmm_forward_backward_counts_fused",
    "hmm_forward_backward_counts_fused_reference",
    "ALL_TRACKS",
    "hgf_update",
    "hgf_filter_fused",
    "hgf_filter_fused_reference",
]
