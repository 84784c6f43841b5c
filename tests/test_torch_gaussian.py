"""Port parity: ``cortex_tpu_torch.dists`` (Gaussian, MvGaussian, Beta, Gamma,
Bernoulli, Categorical) against ``cortex_tpu.dists``.

The same parameters, made from a seed with numpy, go through both packages
on the CPU.  Moments, ``*``, ``/``, ``reduce_product``, log normalizer,
entropy, KL and logpdf agree at rtol 1e-6 (atol 1e-6 for values near 0), in
float32 and, with JAX's 64-bit types switched on for the call, in float64.
Two exceptions in float32: the digamma and log-gamma of the two libraries
differ by a few float32 ulps, so Beta's and Gamma's log normalizer, entropy,
``mean_log`` and KL agree there at rtol = atol = 1e-5 (in float64 at 1e-6);
MvGaussian's moments pass through an elimination of 3x3 matrices, at rtol
1e-5.  The SPD helpers agree at rtol 1e-5 (atol 1e-5) at d = 1, 2, 3, 5 and
at d = 33, where both packages call their library (LAPACK by two routes).
Samples are held by moments, not by values: over 200,000 draws the sample
mean and variance are within 5 standard errors of the exact ones.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import cortex_tpu_torch.dists as P
from cortex_tpu_torch.dists import gaussian as tgauss

import cortex_tpu.dists as J
from cortex_tpu.dists import gaussian as jgauss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them,
    8-20x slower on small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

RTOL = ATOL = 1e-6
SHAPE = (3, 4)


SPECIAL_F32 = 1e-5  # digamma and log-gamma in float32, by two libraries
DTYPES = [np.float32, np.float64]


def _close(port, ref, rtol=RTOL, atol=ATOL):
    assert isinstance(port, torch.Tensor)
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    assert port.numpy().dtype == ref.dtype
    np.testing.assert_allclose(port.numpy(), ref, rtol=rtol, atol=atol)


def _special_tol(family, dtype):
    if dtype == np.float32 and family in ("Beta", "Gamma"):
        return dict(rtol=SPECIAL_F32, atol=SPECIAL_F32)
    if dtype == np.float32 and family == "MvGaussian":
        return dict(rtol=1e-5, atol=ATOL)
    return dict(rtol=RTOL, atol=ATOL)


def _pos(rng, shape=SHAPE, low=0.5, high=4.0):
    return rng.uniform(low, high, size=shape).astype(np.float32)


def _params(family, seed):
    """Fields of one distribution of ``family`` as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    if family == "Gaussian":
        return {"xi": rng.normal(size=SHAPE).astype(np.float32), "w": _pos(rng)}
    if family == "MvGaussian":
        d = 3
        a = rng.normal(size=SHAPE + (d, d))
        W = a @ np.swapaxes(a, -1, -2) + d * np.eye(d)
        return {"xi": rng.normal(size=SHAPE + (d,)).astype(np.float32),
                "W": W.astype(np.float32)}
    if family == "Beta":
        return {"a": _pos(rng), "b": _pos(rng)}
    if family == "Gamma":
        return {"shape": _pos(rng), "rate": _pos(rng)}
    if family == "Bernoulli":
        return {"logit": rng.normal(size=SHAPE).astype(np.float32)}
    if family == "Categorical":
        return {"logits": rng.normal(size=SHAPE + (5,)).astype(np.float32)}
    raise ValueError(family)


def _pair(family, seed, dtype=np.float32):
    p = {k: v.astype(dtype) for k, v in _params(family, seed).items()}
    port = getattr(P, family)(**{k: torch.from_numpy(v) for k, v in p.items()})
    ref = getattr(J, family)(**{k: jnp.asarray(v) for k, v in p.items()})
    return port, ref


FAMILIES = ["Gaussian", "MvGaussian", "Beta", "Gamma", "Bernoulli", "Categorical"]
PROPERTIES = {
    "Gaussian": ["mean", "variance", "precision"],
    "MvGaussian": ["mean", "cov", "precision"],
    "Beta": ["mean", "variance"],
    "Gamma": ["mean", "variance", "scale"],
    "Bernoulli": ["prob", "mean", "variance"],
    "Categorical": ["probs", "mean"],
}
METHODS = {
    "Gaussian": ["log_normalizer", "entropy"],
    "MvGaussian": ["log_normalizer", "entropy"],
    "Beta": ["log_normalizer", "entropy"],
    "Gamma": ["log_normalizer", "entropy", "mean_log"],
    "Bernoulli": ["log_normalizer", "entropy"],
    "Categorical": ["log_normalizer", "entropy"],
}


@pytest.mark.parametrize("family", FAMILIES)
def test_moments_match_jax(family):
    port, ref = _pair(family, 0)
    for name in PROPERTIES[family]:
        rtol = 1e-5 if family == "MvGaussian" else RTOL
        _close(getattr(port, name), getattr(ref, name), rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_normalizer_and_entropy_match_jax(family, dtype):
    with jax.enable_x64(dtype == np.float64):
        port, ref = _pair(family, 1, dtype)
        for name in METHODS[family]:
            _close(getattr(port, name)(), getattr(ref, name)(), **_special_tol(family, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_product_quotient_and_kl_match_jax(family, dtype):
    with jax.enable_x64(dtype == np.float64):
        p, jp = _pair(family, 2, dtype)
        q, jq = _pair(family, 3, dtype)
        for port, ref in ((p * q, jp * jq), (p / q, jp / jq)):
            assert type(port).__name__ == type(ref).__name__ == family
            for field in _params(family, 0):
                _close(getattr(port, field), getattr(ref, field))
        if hasattr(jp, "kl"):
            _close(p.kl(q), jp.kl(jq), **_special_tol(family, dtype))
            _close(q.kl(p), jq.kl(jp), **_special_tol(family, dtype))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("family", FAMILIES)
def test_reduce_product_matches_jax_and_the_pairwise_fold(family, axis):
    port, ref = _pair(family, 4)
    got = type(port).reduce_product(port, axis=axis)
    want = type(ref).reduce_product(ref, axis=axis)
    parts = [type(port)(**{f: getattr(port, f).select(axis, i) for f in _params(family, 0)})
             for i in range(getattr(port, next(iter(_params(family, 0)))).shape[axis])]
    fold = parts[0]
    for part in parts[1:]:
        fold = fold * part
    for field in _params(family, 0):
        _close(getattr(got, field), getattr(want, field))
        torch.testing.assert_close(getattr(got, field), getattr(fold, field), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["Gaussian", "MvGaussian", "Beta", "Gamma"])
def test_logpdf_matches_jax(family):
    port, ref = _pair(family, 5)
    rng = np.random.default_rng(6)
    if family == "Gaussian":
        x = rng.normal(size=SHAPE)
    elif family == "MvGaussian":
        x = rng.normal(size=SHAPE + (3,))
    elif family == "Beta":
        x = rng.uniform(0.05, 0.95, size=SHAPE)
    else:
        x = rng.uniform(0.1, 5.0, size=SHAPE)
    x = x.astype(np.float32)
    _close(port.logpdf(torch.from_numpy(x)), ref.logpdf(jnp.asarray(x)),
           rtol=1e-5 if family == "MvGaussian" else RTOL)


@pytest.mark.parametrize("ctor", ["from_mean_variance", "from_mean_precision"])
def test_constructors_from_python_and_numpy_make_float32(ctor):
    for args in ((0.5, 2.0), (np.float64(0.5), np.array([1.0, 2.0, 4.0]))):
        port = getattr(P, ctor)(*args, device="cpu")
        ref = getattr(J, ctor)(*args)
        _close(port.xi, ref.xi)
        _close(port.w, ref.w)
        assert port.xi.device.type == "cpu"


def test_mv_constructors_match_jax():
    p = _params("MvGaussian", 7)
    mean = np.random.default_rng(8).normal(size=SHAPE + (3,)).astype(np.float32)
    for ctor, mat in (("mv_from_mean_precision", p["W"]), ("mv_from_mean_cov", p["W"])):
        port = getattr(P, ctor)(torch.from_numpy(mean), torch.from_numpy(mat))
        ref = getattr(J, ctor)(jnp.asarray(mean), jnp.asarray(mat))
        _close(port.xi, ref.xi, rtol=1e-5, atol=1e-5)
        _close(port.W, ref.W, rtol=1e-5, atol=1e-5)


def test_family_constructors_match_jax():
    p = np.array([0.2, 0.5, 0.9], np.float32)
    _close(P.Bernoulli.from_prob(p, device="cpu").logit, J.Bernoulli.from_prob(p).logit)
    probs = np.array([[0.1, 0.2, 0.7], [0.3, 0.3, 0.4]], np.float32)
    _close(P.Categorical.from_probs(probs, device="cpu").logits,
           J.Categorical.from_probs(probs).logits)
    g, jg = P.Gamma.from_shape_scale(2.0, p, device="cpu"), J.Gamma.from_shape_scale(2.0, p)
    _close(g.shape, jg.shape)
    _close(g.rate, jg.rate)


# -- the SPD helpers ------------------------------------------------------------


def _spd(d, seed, batch=(4,)):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=batch + (d, d))
    return (a @ np.swapaxes(a, -1, -2) / d + np.eye(d)).astype(np.float32)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 33])
def test_spd_helpers_match_jax(d):
    M = _spd(d, d)
    B = np.random.default_rng(100 + d).normal(size=(4, d, 2)).astype(np.float32)
    tM, jM = torch.from_numpy(M), jnp.asarray(M)
    sol, logdet = tgauss._spd_solve_logdet(tM, torch.from_numpy(B))
    jsol, jlogdet = jgauss._spd_solve_logdet(jM, jnp.asarray(B))
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(sol, jsol, **tol)
    _close(logdet, jlogdet, **tol)
    _close(tgauss._spd_inv(tM), jgauss._spd_inv(jM), **tol)
    _close(tgauss._spd_logdet(tM), jgauss._spd_logdet(jM), **tol)
    _close(tgauss._spd_cholesky(tM), jgauss._spd_cholesky(jM), **tol)


@pytest.mark.parametrize("d", [2, 33])
def test_cholesky_of_a_matrix_that_is_not_positive_definite_is_nan(d):
    M = -np.eye(d, dtype=np.float32)[None]
    got = tgauss._spd_cholesky(torch.from_numpy(M))
    want = np.asarray(jgauss._spd_cholesky(jnp.asarray(M)))
    assert np.isnan(want).any()
    assert torch.isnan(got).any()
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want)) or d > 32
    assert bool(torch.isnan(tgauss._cholesky_nan(torch.from_numpy(M))).all())


# -- sampling, by moments ---------------------------------------------------------

N_DRAWS = 200_000


def _generator(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _moments_close(draws, mean, var, fourth=None):
    """Sample mean and variance within 5 standard errors of ``mean`` and
    ``var``."""
    draws = draws.double()
    n = draws.shape[0]
    m, v = draws.mean(0).numpy(), draws.var(0).numpy()
    mean, var = np.asarray(mean, np.float64), np.asarray(var, np.float64)
    assert np.all(np.abs(m - mean) <= 5 * np.sqrt(var / n) + 1e-6)
    # Var of the sample variance ~ (m4 - var^2) / n; m4 <= 15 var^2 for these.
    assert np.all(np.abs(v - var) <= 5 * np.sqrt(14 * var**2 / n) + 1e-6)


@pytest.mark.parametrize("family", ["Gaussian", "Beta", "Gamma", "Bernoulli"])
def test_samples_have_the_moments_of_jax(family):
    port, ref = _pair(family, 9)
    port = type(port)(**{f: getattr(port, f)[0, :3] for f in _params(family, 0)})
    ref = type(ref)(**{f: getattr(ref, f)[0, :3] for f in _params(family, 0)})
    draws = port.sample(_generator(0), (N_DRAWS,))
    assert tuple(draws.shape) == (N_DRAWS, 3)
    _moments_close(draws, np.asarray(ref.mean), np.asarray(ref.variance))


def test_gamma_samples_below_shape_one():
    g = P.Gamma(torch.tensor([0.2, 0.7]), torch.tensor([1.0, 3.0]))
    _moments_close(g.sample(_generator(1), (N_DRAWS,)), g.mean.numpy(), g.variance.numpy())


def test_mv_gaussian_samples_have_its_mean_and_covariance():
    p = _params("MvGaussian", 10)
    port = P.MvGaussian(torch.from_numpy(p["xi"][0, 0]), torch.from_numpy(p["W"][0, 0]))
    ref = J.MvGaussian(jnp.asarray(p["xi"][0, 0]), jnp.asarray(p["W"][0, 0]))
    draws = port.sample(_generator(2), (N_DRAWS,)).double()
    cov = np.asarray(ref.cov, np.float64)
    _moments_close(draws, np.asarray(ref.mean), np.diag(cov))
    np.testing.assert_allclose(np.cov(draws.numpy().T), cov, atol=5 * np.sqrt(2 / N_DRAWS) * 4)


def test_categorical_and_dirichlet_samples_have_their_means():
    logits = np.log(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    draws = P.Categorical(torch.from_numpy(logits)).sample(_generator(3), (N_DRAWS,))
    freq = torch.bincount(draws, minlength=4).double() / N_DRAWS
    probs = np.asarray(J.Categorical(jnp.asarray(logits)).probs)
    assert np.all(np.abs(freq.numpy() - probs) <= 5 * np.sqrt(probs * (1 - probs) / N_DRAWS))
    alpha = np.array([[0.5, 1.0, 3.0], [2.0, 2.0, 2.0]], np.float32)
    d = P.Dirichlet(torch.from_numpy(alpha))
    x = d.sample(_generator(4), (N_DRAWS,))
    assert tuple(x.shape) == (N_DRAWS, 2, 3)
    torch.testing.assert_close(x.sum(-1), torch.ones(N_DRAWS, 2), rtol=0, atol=1e-5)
    a0 = alpha.sum(-1, keepdims=True)
    mean = np.asarray(J.Dirichlet(jnp.asarray(alpha)).mean)
    _moments_close(x, mean, mean * (1 - mean) / (a0 + 1))
    assert math.isclose(float(x.min()), float(x.min()))  # finite
