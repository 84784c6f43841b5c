"""Carry model parameters, smoother operators, priors, states and fitted results across from numpy.

These take what the JAX package produces, as plain Python or numpy values
(``dataclasses.asdict`` of a model or a distribution, ``np.asarray`` of
arrays), and return the port's objects, so the two packages compute the same thing on the same
inputs.  They import neither package's arrays: numpy is the common ground.
Those that make tensors put them on the card unless the caller names
another ``device``.  :func:`checkpoint_from_jax` reads a checkpoint file that
the JAX package wrote.
"""

from __future__ import annotations

import dataclasses

from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dists
from .models.ep_classifier import EPClassifierPosterior
from .models.glm import NIGPosterior, PoissonPosterior
from .models.gmm import GMMPosterior
from .models.gmm_full import GMMFullPosterior
from .models.hgf import HGF, HGFState
from .models.hgf_binary import BinaryHGF, BinaryHGFState
from .models.hmm import HMM, HMMVMPState
from .models.lgssm import LGSSM
from .models.gp import GP, GPPosterior
from .models.gp_ssm import GPSSMPosterior
from .models.gpc import GPClassifier, GPCPosterior
from .models.mv_lgssm import MvLGSSM
from .models.nlssm import NonlinearSSM
from .models.ppca import FAResult, PPCAResult
from .models.sgp import SGPR, SGPRPosterior
from .models.slds import SLDS
from .ops.chains_mv import MvSmootherOperator
from .ops.cvi import CVIResult
from .ops.ep import EPResult
from .ops.kernels_hgf import PARAMS as HGF_PARAMS
from .utils.tree import tree_flatten, tree_unflatten

__all__ = [
    "binary_hgf_from_numpy",
    "checkpoint_from_jax",
    "binary_hgf_state_from_numpy",
    "dist_from_numpy",
    "dists_from_numpy",
    "fitted_from_numpy",
    "gp_posterior_from_numpy",
    "gmm_full_posterior_from_numpy",
    "gmm_posterior_from_numpy",
    "hgf_from_numpy",
    "hgf_state_from_numpy",
    "hmm_from_numpy",
    "hmm_state_from_numpy",
    "lgssm_from_numpy",
    "mv_lgssm_from_numpy",
    "mv_operator_from_numpy",
    "nlssm_from_numpy",
    "operator_from_numpy",
    "prior_from_numpy",
    "slds_from_numpy",
]

_HGF_PARAMS = set(HGF_PARAMS)
_BINARY_HGF_PARAMS = {"kappa", "omega", "theta", "max_log_nu", "min_pi3", "max_mu3_step"}


def _floats(params: Mapping[str, object], known: set, model: str) -> dict:
    """``params`` as Python floats; raises on a key not in ``known``."""
    unknown = set(params) - known
    if unknown:
        raise ValueError(f"not {model} parameters: {sorted(unknown)}")
    return {k: float(v) for k, v in params.items()}


def lgssm_from_numpy(params: Mapping[str, object]) -> LGSSM:
    """The port's :class:`LGSSM` from ``{"A", "Q", "H", "R"}`` (for example
    ``dataclasses.asdict`` of the JAX ``LGSSM``).  Other keys raise."""
    return LGSSM(**_floats(params, {"A", "Q", "H", "R"}, "LGSSM"))


def operator_from_numpy(
    operator: Sequence[object], device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The smoother operator ``(S, c, v)`` of ``lgssm_smoother_operator`` as
    tensors on ``device``, in the arrays' own dtype."""
    S, c, v = (torch.tensor(np.asarray(a), device=device) for a in operator)
    T = S.shape[-1]
    if S.shape != (T, T) or c.shape != (T,) or v.shape != (T,):
        raise ValueError(
            f"operator must be (T, T), (T,), (T,); got {S.shape}, {c.shape}, {v.shape}"
        )
    return S, c, v


def prior_from_numpy(
    prior: Optional[Sequence[object]], dtype=torch.float32, device="cuda"
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """A ``(mean, variance)`` prior as tensors (scalars or batch-shaped);
    ``None`` stays ``None``."""
    if prior is None:
        return None
    mean, var = prior
    return (
        torch.tensor(np.asarray(mean), dtype=dtype, device=device),
        torch.tensor(np.asarray(var), dtype=dtype, device=device),
    )


def mv_lgssm_from_numpy(params: Mapping[str, object]) -> MvLGSSM:
    """The port's :class:`MvLGSSM` from ``{"A", "Q", "H", "R", "m0", "P0"}``
    (for example ``dataclasses.asdict`` of the JAX ``MvLGSSM``), held as
    tuples as that model holds them.  Other or missing keys raise."""
    fields = {f.name for f in dataclasses.fields(MvLGSSM)}
    if set(params) != fields:
        raise ValueError(f"MvLGSSM has fields {sorted(fields)}, got {sorted(params)}")
    return MvLGSSM.from_arrays(**params)


def slds_from_numpy(params: Mapping[str, object], device="cuda") -> SLDS:
    """The port's :class:`SLDS` from ``{"Pi", "A", "Q", "H", "R", "prior",
    "regime_prior"}`` (for example ``dataclasses.asdict`` of the JAX
    ``SLDS``; ``prior`` and ``regime_prior`` may be left out): the arrays on
    ``device`` in their own dtype, ``prior`` as floats.  Other keys raise."""
    unknown = set(params) - {"Pi", "A", "Q", "H", "R", "prior", "regime_prior"}
    if unknown:
        raise ValueError(f"not SLDS parameters: {sorted(unknown)}")

    fields = {k: v if k == "prior" or v is None else torch.tensor(np.asarray(v), device=device)
              for k, v in params.items()}
    return SLDS(**fields)


def mv_operator_from_numpy(operator: Sequence[object], device="cuda") -> MvSmootherOperator:
    """An ``MvSmootherOperator`` ``(L, c, cov)`` of
    ``mv_lgssm_smoother_operator`` as tensors on ``device``, in the arrays'
    own dtype."""
    L, c, cov = (torch.tensor(np.asarray(a), device=device) for a in operator)
    T, d = c.shape if c.ndim == 2 else (0, 0)
    if T == 0 or L.ndim != 2 or L.shape[1] != T * d or L.shape[0] % T or cov.shape != (T, d, d):
        raise ValueError(
            "operator must be (T*m, T*d), (T, d), (T, d, d); got "
            f"{tuple(L.shape)}, {tuple(c.shape)}, {tuple(cov.shape)}"
        )
    return MvSmootherOperator(L, c, cov)


def _tensors(values: Sequence[object], n: int, what: str, device):
    values = list(values)
    if len(values) != n:
        raise ValueError(f"{what} has {n} fields, got {len(values)}")
    return [torch.tensor(np.asarray(v), device=device) for v in values]


def gmm_posterior_from_numpy(posterior: Sequence[object], device="cuda") -> GMMPosterior:
    """A :class:`GMMPosterior` from its five arrays ``(alpha, m, beta, a,
    b)`` (for example a JAX ``GMMPosterior``), on ``device`` in the arrays'
    own dtype."""
    return GMMPosterior(*_tensors(posterior, 5, "GMMPosterior", device))


def gmm_full_posterior_from_numpy(posterior: Sequence[object], device="cuda") -> GMMFullPosterior:
    """A :class:`GMMFullPosterior` from its five arrays ``(alpha, m, beta,
    W, nu)`` (for example a JAX ``GMMFullPosterior``), on ``device`` in the
    arrays' own dtype."""
    return GMMFullPosterior(*_tensors(posterior, 5, "GMMFullPosterior", device))


def hmm_from_numpy(params: Mapping[str, object], device="cuda") -> HMM:
    """The port's :class:`HMM` from ``{"K", "log_pi"}`` (for example
    ``dataclasses.asdict`` of the JAX ``HMM``), ``log_pi`` on ``device`` in
    its own dtype.  Other keys raise."""
    unknown = set(params) - {"K", "log_pi"}
    if unknown:
        raise ValueError(f"not HMM parameters: {sorted(unknown)}")
    return HMM(int(params["K"]), torch.tensor(np.asarray(params["log_pi"]), device=device))


def hmm_state_from_numpy(trans_alpha, emis_alpha, device="cuda") -> HMMVMPState:
    """An :class:`HMMVMPState` (for example the fields of a JAX
    ``HMMVMPState``) as tensors on ``device``, in the arrays' own dtype;
    ``emis_alpha`` may be ``None``."""
    def tensor(a):
        return None if a is None else torch.tensor(np.asarray(a), device=device)

    return HMMVMPState(tensor(trans_alpha), tensor(emis_alpha))


def hgf_from_numpy(params: Mapping[str, object]) -> HGF:
    """The port's :class:`HGF` from its parameters (for example
    ``dataclasses.asdict`` of the JAX ``HGF``), as Python floats.  Other keys
    raise."""
    return HGF(**_floats(params, _HGF_PARAMS, "HGF"))


def binary_hgf_from_numpy(params: Mapping[str, object]) -> BinaryHGF:
    """The port's :class:`BinaryHGF` from its parameters (for example
    ``dataclasses.asdict`` of the JAX ``BinaryHGF``).  Other keys raise."""
    return BinaryHGF(**_floats(params, _BINARY_HGF_PARAMS, "BinaryHGF"))


def hgf_state_from_numpy(state: Sequence[object], device="cuda") -> HGFState:
    """An :class:`HGFState` from its four arrays ``(mu1, pi1, mu2, pi2)``
    (for example a JAX ``HGFState``), on ``device`` in the arrays' own dtype."""
    return HGFState(*(torch.tensor(np.asarray(a), device=device) for a in state))


def binary_hgf_state_from_numpy(state: Sequence[object], device="cuda") -> BinaryHGFState:
    """A :class:`BinaryHGFState` from its four arrays ``(mu2, pi2, mu3,
    pi3)``, on ``device`` in the arrays' own dtype."""
    return BinaryHGFState(*(torch.tensor(np.asarray(a), device=device) for a in state))


DISTRIBUTIONS = ("Gaussian", "MvGaussian", "Beta", "Gamma", "Bernoulli", "Categorical",
                 "Dirichlet", "NormalGamma", "Wishart", "Poisson")


def dist_from_numpy(name: str, fields: Mapping[str, object], device="cuda"):
    """The port's distribution of class ``name`` (one of
    :data:`DISTRIBUTIONS`) from its fields (for example
    ``dataclasses.asdict`` of a JAX ``Gaussian``), as tensors on ``device``
    in the arrays' own dtype.  Another class or other fields raise."""
    if name not in DISTRIBUTIONS:
        raise ValueError(f"not a distribution of the port: {name!r}")
    cls = getattr(dists, name)
    expected = {f.name for f in dataclasses.fields(cls)}
    if set(fields) != expected:
        raise ValueError(f"{name} has fields {sorted(expected)}, got {sorted(fields)}")
    return cls(**{k: torch.tensor(np.asarray(v), device=device) for k, v in fields.items()})


def dists_from_numpy(values: Sequence[Any], device="cuda") -> List[Any]:
    """A list of values (for example ``CompiledInference.initial_state()``
    or the state that ``iterate`` returns), each a ``(name, fields)`` pair
    for :func:`dist_from_numpy` or an array, which becomes a tensor on
    ``device`` in its own dtype."""
    out = []
    for v in values:
        if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str):
            out.append(dist_from_numpy(v[0], v[1], device=device))
        else:
            out.append(torch.tensor(np.asarray(v), device=device))
    return out


# The fitted results carried across field by field; an ``ep`` field is an
# EPResult, a ``likelihood`` a string.
FITTED = (NIGPosterior, PoissonPosterior, EPResult, CVIResult, EPClassifierPosterior,
          PPCAResult, FAResult, GPSSMPosterior)


def fitted_from_numpy(cls, values: Sequence[Any], device="cuda"):
    """A fitted result of class ``cls`` (one of :data:`FITTED`; the AR
    posterior is ``NIGPosterior``) from its fields in order (for example the
    JAX result itself), arrays as tensors on ``device`` in their own dtype.
    Another class or another number of fields raises."""
    if cls not in FITTED:
        raise ValueError(f"not a fitted result of the port: {cls!r}")
    values = list(values)
    if len(values) != len(cls._fields):
        raise ValueError(f"{cls.__name__} has {len(cls._fields)} fields, got {len(values)}")
    fields = []
    for name, v in zip(cls._fields, values):
        if name == "ep":
            v = fitted_from_numpy(EPResult, v, device=device)
        elif name != "likelihood":
            v = torch.tensor(np.asarray(v), device=device)
        fields.append(v)
    return cls(*fields)


_POSTERIORS = {GPPosterior: GP, SGPRPosterior: SGPR, GPCPosterior: GPClassifier}


def gp_posterior_from_numpy(cls, params: Mapping[str, object], arrays: Mapping[str, object],
                            device="cuda"):
    """A GP posterior of class ``cls`` (``GPPosterior``, ``SGPRPosterior`` or
    ``GPCPosterior``) rebuilt with its ``predict`` from the model's
    parameters (for example ``dataclasses.asdict`` of the JAX model) and the
    arrays its prediction closes over, named as the arguments of the port
    model's ``posterior`` method (``GP``: ``X, alpha, L, lml``; ``SGPR``:
    ``Z, L, LB, c, elbo``; ``GPClassifier``: ``X, tau, nu, latent_mean, L,
    alpha, delta``), as tensors on ``device`` in their own dtype."""
    if cls not in _POSTERIORS:
        raise ValueError(f"not a GP posterior of the port: {cls!r}")
    model = _POSTERIORS[cls](**params)
    return model.posterior(**{k: torch.tensor(np.asarray(v), device=device)
                              for k, v in arrays.items()})


def nlssm_from_numpy(params: Mapping[str, object], f, h, device="cuda") -> NonlinearSSM:
    """The port's :class:`NonlinearSSM` from its arrays ``{"Q", "R", "m0",
    "P0"}`` (for example from ``dataclasses.asdict`` of the JAX model, less
    its callables) on ``device`` in their own dtype, with the torch
    callables ``f`` and ``h``.  Other or missing keys raise."""
    if set(params) != {"Q", "R", "m0", "P0"}:
        raise ValueError(f"NonlinearSSM takes the arrays Q, R, m0, P0; got {sorted(params)}")
    return NonlinearSSM(f, h, **{k: torch.tensor(np.asarray(v), device=device)
                                 for k, v in params.items()})


def checkpoint_from_jax(path: str, like: Any, device="cuda") -> Any:
    """Read a checkpoint written by ``cortex_tpu.checkpoint.save`` into the
    structure of ``like`` (a tree of the port's tensors), on ``device``.

    JAX's structure text cannot equal the port's, so this checks the number of
    leaves and each leaf's shape and dtype against ``like``'s instead; it
    relies on both packages flattening dataclass fields in order, named
    tuples by field and dict keys sorted.  A mismatch raises ``ValueError``."""
    leaves_like, treedef = tree_flatten(like)
    with np.load(path) as data:
        saved = sorted((k for k in data.files if k.startswith("leaf_")),
                       key=lambda k: int(k.removeprefix("leaf_")))
        if len(saved) != len(leaves_like):
            raise ValueError(
                f"Checkpoint structure mismatch: {len(saved)} leaves saved, "
                f"{len(leaves_like)} expected")
        leaves = []
        for i, (key, leaf) in enumerate(zip(saved, leaves_like)):
            array = data[key]
            want = torch.as_tensor(leaf)
            got = torch.from_numpy(np.ascontiguousarray(array))
            if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
                raise ValueError(
                    f"Checkpoint leaf {i} is {got.dtype} {tuple(got.shape)}, "
                    f"expected {want.dtype} {tuple(want.shape)}")
            leaves.append(got.to(device))
    return tree_unflatten(treedef, leaves)
