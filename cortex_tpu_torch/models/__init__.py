"""Model families of the port, in PyTorch."""

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
from .gmm_full import GMMFull, GMMFullPosterior, GMMFullResult
from .hgf import HGF, HGFState, HGFTrajectory
from .hgf_binary import BinaryHGF, BinaryHGFState, BinaryHGFTrajectory
from .hmm import HMM, HMMVMPResult, HMMVMPState
from .lgssm import LGSSM
from .lgssm_graph import LGSSMChainBatched, LGSSMChainDynamic, ScalarNormal, make_chain_graph
from .mv_lgssm import MvLGSSM
from .particle import ParticleFilterResult, particle_filter, systematic_resample
from .rbpf import RBPFResult, rbpf_filter
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
]
