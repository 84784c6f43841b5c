"""cortex_tpu_torch — the PyTorch and CUDA port of cortex_tpu, for NVIDIA Hopper.

It mirrors the JAX package's layout, so each module has its counterpart at
the same path (the Pallas kernels' at ``ops/kernels*.py``):

- :mod:`cortex_tpu_torch.core` — the reactive signal substrate, factor-graph
  model spec, dependency resolvers (BP / mean-field / structured VMP) and
  the dynamic inference engine (re-exported here, as in the JAX package),
- :mod:`cortex_tpu_torch.compile` — the static schedule compiler: dependency
  DAG → phased, type-batched tensor programs, run on the inputs' device,
- :mod:`cortex_tpu_torch.ops` — scalar-chain message passing (scan, matmul
  and associative-scan smoothers), vector-state chains (scan, blocked,
  associative-scan and matmul smoothers, filter, log evidence), the
  square-root and robust (Student-t) smoothers, free energies,
  discrete-chain forward-backward and Viterbi, the HGF step, nonlinear
  (EKF/UKF) filters, GaBP, HMC, EP and CVI, and the CUDA kernels written by
  hand for ``sm_90a`` (the fused smoothing sweep, the scaled HMM
  forward-backward, the HGF filter), each an operator of the
  ``cortex_tpu_torch`` namespace beside its plain PyTorch twin,
- :mod:`cortex_tpu_torch.dists` — exponential families (Gaussian,
  MvGaussian, Beta, Gamma, Bernoulli, Categorical, Dirichlet, NormalGamma,
  Wishart, Poisson),
- :mod:`cortex_tpu_torch.models` — the model zoo (LGSSM, MvLGSSM, HMM, HGF,
  binary HGF, the VB-GMMs, SLDS, particle and Rao-Blackwellized particle
  filters, nonlinear SSMs, GLMs and the EP classifier, AR, GPs, sparse GPs,
  GP classification, GP state-space models, PPCA/FA, BOCPD), the ML fits
  and the factor graphs of the compiled path,
- :mod:`cortex_tpu_torch.parallel` — explicit SPMD on ``torch.distributed``
  (meshes, collectives, replica- and time-sharded and pipelined smoothing)
  and streaming with copies overlapped with compute,
- :mod:`cortex_tpu_torch.serve` — ``torch.export`` programs captured into
  one CUDA graph per shape, serialized programs and bucketed serving,
- :mod:`cortex_tpu_torch.checkpoint` — tree checkpoints and retention,
- :mod:`cortex_tpu_torch.diag` — non-finite checks, convergence monitoring,
  R̂ and ESS,
- :mod:`cortex_tpu_torch.viz` — DOT rendering of signals and schedules,
- :mod:`cortex_tpu_torch.native` — the C++ signal core, built with ``g++``,
- :mod:`cortex_tpu_torch.convert` — carry parameters, operators, states and
  checkpoints across from the JAX package,
- :mod:`cortex_tpu_torch.utils` — time formatting and the tree helper.

It imports ``torch`` and never ``jax``.  CUDA kernels are built with
``nvcc`` and the native core with ``g++`` at first use, never at import.
"""

__version__ = "0.1.0"

from .core import *  # noqa: F401,F403
from .core import __all__ as _core_all

# Submodules load lazily (PEP 562), as in the JAX package.
_SUBMODULES = ("checkpoint", "compile", "convert", "core", "diag", "dists", "models", "native",
               "ops", "parallel", "serve", "utils", "viz")

__all__ = list(_core_all) + ["__version__"] + list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
