"""cortex_tpu_torch — the PyTorch and CUDA port of cortex_tpu, for NVIDIA Hopper.

It mirrors the JAX package's layout, so each function has its counterpart
at the same path:

- :mod:`cortex_tpu_torch.ops` — scalar-chain message passing (scan, matmul
  and associative-scan smoothers), discrete-chain forward-backward and
  Viterbi, and the CUDA kernels written by hand for ``sm_90a`` (the fused
  smoothing sweep, the scaled HMM forward-backward), each with a plain
  PyTorch twin,
- :mod:`cortex_tpu_torch.dists` — exponential families (Dirichlet),
- :mod:`cortex_tpu_torch.models` — model families (LGSSM, HMM),
- :mod:`cortex_tpu_torch.convert` — carry parameters and operators across
  from numpy.

It imports ``torch`` and never ``jax``.  CUDA kernels are built with
``nvcc`` at first use on a CUDA tensor, never at import.
"""

__version__ = "0.1.0"

# Submodules load lazily (PEP 562), as in the JAX package.
_SUBMODULES = ("convert", "dists", "models", "ops")

__all__ = ["__version__"] + list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
