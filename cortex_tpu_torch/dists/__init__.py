"""Exponential-family message algebra as batched PyTorch tensors."""

from .conjugate import Dirichlet

__all__ = ["Dirichlet"]
