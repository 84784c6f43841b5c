"""cortex_tpu_torch — the PyTorch and CUDA port of cortex_tpu, for NVIDIA Hopper.

It mirrors the JAX package's layout, so each function has its counterpart
at the same path:

- :mod:`cortex_tpu_torch.ops` — scalar-chain message passing (scan, matmul
  and associative-scan smoothers), discrete-chain forward-backward and
  Viterbi, the HGF step, and the CUDA kernels written by hand for
  ``sm_90a`` (the fused smoothing sweep, the scaled HMM forward-backward,
  the HGF filter), each with a plain PyTorch twin,
- :mod:`cortex_tpu_torch.dists` — exponential families (Dirichlet),
- :mod:`cortex_tpu_torch.models` — model families (LGSSM, HMM, HGF,
  binary HGF) and the scalar fits,
- :mod:`cortex_tpu_torch.parallel` — streaming with copies overlapped with
  compute,
- :mod:`cortex_tpu_torch.convert` — carry parameters, operators and states
  across from numpy.

It imports ``torch`` and never ``jax``.  CUDA kernels are built with
``nvcc`` at first use on a CUDA tensor, never at import.
"""

__version__ = "0.1.0"

# Submodules load lazily (PEP 562), as in the JAX package.
_SUBMODULES = ("convert", "dists", "models", "ops", "parallel")

__all__ = ["__version__"] + list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
