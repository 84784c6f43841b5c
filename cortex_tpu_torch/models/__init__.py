"""Model families of the port, in PyTorch."""

from ..utils import spans as _spans

# The subpackage's imports: a set-up span of the process.
with _spans.setup_span("setup.import"):
    from .ar import ARPosterior, BayesianAR, companion_matrix, latent_ar_smooth
    from .bocpd import BOCPD, BOCPDResult, BernoulliBeta, GaussianNIG
    from .ep_classifier import EPClassifier, EPClassifierPosterior
    from .glm import (
        BayesianLinearRegression,
        NIGPosterior,
        PoissonPosterior,
        PoissonRegression,
        nig_fit,
    )
    from . import fit
    from .fit import (
        LGSSMParams,
        MvLGSSMParams,
        fit_hgf_ml,
        fit_lgssm_em,
        fit_lgssm_ml,
        fit_mv_lgssm_ml,
    )
    from .gmm import GMM, GMMPosterior, GMMResult
    from .gp import GP, GPPosterior, fit_gp_ml
    from .gp_ssm import GPSSM, GPSSMPosterior, fit_gpssm_ml, matern_state_space
    from .gpc import GPClassifier, GPCPosterior
    from .gmm_full import GMMFull, GMMFullPosterior, GMMFullResult
    from .hgf import HGF, HGFState, HGFTrajectory
    from .hgf_binary import BinaryHGF, BinaryHGFState, BinaryHGFTrajectory
    from .hmm import HMM, HMMVMPResult, HMMVMPState
    from .lgssm import LGSSM
    from .lgssm_graph import LGSSMChainBatched, LGSSMChainDynamic, ScalarNormal, make_chain_graph
    from .mv_lgssm import MvLGSSM
    from .nlssm import NLSSMBeliefs, NonlinearSSM
    from .particle import ParticleFilterResult, particle_filter, systematic_resample
    from .ppca import FactorAnalysis, FAResult, PPCA, PPCAResult, ppca_closed_form
    from .rbpf import RBPFResult, rbpf_filter
    from .sgp import SGPR, SGPRPosterior, fit_sgpr_ml
    from .slds import SLDS, SLDSBeliefs
    from .structured_graph import StructuredSSMBatched, make_structured_ssm_graph
    from .vmp_graph import MeanFieldSSMBatched, make_mean_field_ssm_graph

__all__ = [
    "LGSSM",
    "HMM",
    "HMMVMPState",
    "HMMVMPResult",
    "GMM",
    "GMMPosterior",
    "GMMResult",
    "GMMFull",
    "GMMFullPosterior",
    "GMMFullResult",
    "MvLGSSM",
    "SLDS",
    "SLDSBeliefs",
    "RBPFResult",
    "rbpf_filter",
    "ParticleFilterResult",
    "particle_filter",
    "systematic_resample",
    "HGF",
    "HGFState",
    "HGFTrajectory",
    "BinaryHGF",
    "BinaryHGFState",
    "BinaryHGFTrajectory",
    "fit",
    "LGSSMParams",
    "fit_lgssm_ml",
    "fit_lgssm_em",
    "fit_hgf_ml",
    "MvLGSSMParams",
    "fit_mv_lgssm_ml",
    "LGSSMChainBatched",
    "LGSSMChainDynamic",
    "ScalarNormal",
    "make_chain_graph",
    "MeanFieldSSMBatched",
    "make_mean_field_ssm_graph",
    "StructuredSSMBatched",
    "make_structured_ssm_graph",
    "BOCPD",
    "BOCPDResult",
    "GaussianNIG",
    "BernoulliBeta",
    "PPCA",
    "PPCAResult",
    "FactorAnalysis",
    "FAResult",
    "ppca_closed_form",
    "GPSSM",
    "GPSSMPosterior",
    "fit_gpssm_ml",
    "matern_state_space",
    "NonlinearSSM",
    "NLSSMBeliefs",
    "GP",
    "GPPosterior",
    "fit_gp_ml",
    "SGPR",
    "SGPRPosterior",
    "fit_sgpr_ml",
    "BayesianAR",
    "ARPosterior",
    "companion_matrix",
    "latent_ar_smooth",
    "EPClassifier",
    "EPClassifierPosterior",
    "BayesianLinearRegression",
    "NIGPosterior",
    "nig_fit",
    "PoissonRegression",
    "PoissonPosterior",
    "GPClassifier",
    "GPCPosterior",
]
