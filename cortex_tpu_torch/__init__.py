"""cortex_tpu_torch — the PyTorch and CUDA port of cortex_tpu, for NVIDIA Hopper.

It mirrors the JAX package's layout, so each function has its counterpart
at the same path:

- :mod:`cortex_tpu_torch.core` — the reactive signal substrate, factor-graph
  model spec, dependency resolvers (BP / mean-field / structured VMP) and
  the dynamic inference engine (re-exported here, as in the JAX package),
- :mod:`cortex_tpu_torch.compile` — the static schedule compiler: dependency
  DAG → phased, type-batched tensor programs, run on the inputs' device,
- :mod:`cortex_tpu_torch.ops` — scalar-chain message passing (scan, matmul
  and associative-scan smoothers), discrete-chain forward-backward and
  Viterbi, the HGF step, and the CUDA kernels written by hand for
  ``sm_90a`` (the fused smoothing sweep, the scaled HMM forward-backward,
  the HGF filter), each with a plain PyTorch twin,
- :mod:`cortex_tpu_torch.dists` — exponential families (Gaussian,
  MvGaussian, Beta, Gamma, Bernoulli, Categorical, Dirichlet),
- :mod:`cortex_tpu_torch.models` — model families (LGSSM, HMM, HGF,
  binary HGF), the scalar fits and the factor graphs of the compiled path
  (the chain, mean-field and structured SSMs),
- :mod:`cortex_tpu_torch.parallel` — streaming with copies overlapped with
  compute,
- :mod:`cortex_tpu_torch.convert` — carry parameters, operators and states
  across from numpy,
- :mod:`cortex_tpu_torch.utils` — time formatting and the tree helper.

It imports ``torch`` and never ``jax``.  CUDA kernels are built with
``nvcc`` at first use on a CUDA tensor, never at import.
"""

__version__ = "0.1.0"

from .core import *  # noqa: F401,F403
from .core import __all__ as _core_all

# Submodules load lazily (PEP 562), as in the JAX package.
_SUBMODULES = ("compile", "convert", "core", "dists", "models", "ops", "parallel", "utils")

__all__ = list(_core_all) + ["__version__"] + list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
