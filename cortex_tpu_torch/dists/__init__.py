"""Exponential-family message algebra as batched PyTorch tensors.

Distributions are frozen dataclasses of tensors, closed under ``*`` (density
product = natural-parameter addition) and ``/`` (cavity quotient), with
moments, log normalizers, entropies and sampling.  Leading axes are batch
axes: a single ``Gaussian`` value can hold the messages of 10k replicas.
"""

from ..utils import spans as _spans

# The subpackage's imports: a set-up span of the process.
with _spans.setup_span("setup.import"):
    from .gaussian import (
        Gaussian,
        MvGaussian,
        from_mean_precision,
        from_mean_variance,
        mv_from_mean_cov,
        mv_from_mean_precision,
    )
    from .conjugate import Bernoulli, Beta, Categorical, Dirichlet, Gamma
    from .extra import NormalGamma, Poisson, Wishart

__all__ = [
    "Gaussian",
    "MvGaussian",
    "from_mean_variance",
    "from_mean_precision",
    "mv_from_mean_cov",
    "mv_from_mean_precision",
    "Beta",
    "Gamma",
    "Bernoulli",
    "Categorical",
    "Dirichlet",
    "NormalGamma",
    "Wishart",
    "Poisson",
]
