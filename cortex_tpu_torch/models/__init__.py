"""Model families of the port, in PyTorch."""

from . import fit
from .fit import LGSSMParams, fit_hgf_ml, fit_lgssm_em, fit_lgssm_ml
from .hgf import HGF, HGFState, HGFTrajectory
from .hgf_binary import BinaryHGF, BinaryHGFState, BinaryHGFTrajectory
from .hmm import HMM, HMMVMPResult, HMMVMPState
from .lgssm import LGSSM
from .lgssm_graph import LGSSMChainBatched, LGSSMChainDynamic, ScalarNormal, make_chain_graph
from .structured_graph import StructuredSSMBatched, make_structured_ssm_graph
from .vmp_graph import MeanFieldSSMBatched, make_mean_field_ssm_graph

__all__ = [
    "LGSSM",
    "HMM",
    "HMMVMPState",
    "HMMVMPResult",
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
    "LGSSMChainBatched",
    "LGSSMChainDynamic",
    "ScalarNormal",
    "make_chain_graph",
    "MeanFieldSSMBatched",
    "make_mean_field_ssm_graph",
    "StructuredSSMBatched",
    "make_structured_ssm_graph",
]
