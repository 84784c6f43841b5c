"""Model families of the port, in PyTorch."""

from .hmm import HMM, HMMVMPResult, HMMVMPState
from .lgssm import LGSSM

__all__ = ["LGSSM", "HMM", "HMMVMPState", "HMMVMPResult"]
