"""Model families of the port, in PyTorch."""

from .lgssm import LGSSM

__all__ = ["LGSSM"]
