"""Port parity: ``cortex_tpu_torch.dists`` NormalGamma, Wishart and Poisson
against ``cortex_tpu.dists.extra``.

The same parameters, made from a seed with numpy, go through both packages
on the CPU: moments, ``*``, entropy, KL, log normalizer and logpmf agree at
rtol = atol = 1e-5 in float32 (digamma and log-gamma by two libraries differ
by a few float32 ulps) and at 1e-10 in float64, with JAX's 64-bit types
switched on for the call.  Samplers draw from another generator than JAX's,
so they are held by moments and by the JAX tests' Monte-Carlo checks
(tests/test_dists_extra.py), at the bars those tests use.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import cortex_tpu_torch.dists as P
from cortex_tpu_torch import convert

import cortex_tpu.dists as J

DTYPES = [np.float32, np.float64]
TOL = {np.float32: 1e-5, np.float64: 1e-10}
SHAPE = (3, 2)


def _close(port, ref, dtype):
    assert isinstance(port, torch.Tensor)
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    assert port.numpy().dtype == ref.dtype
    np.testing.assert_allclose(port.numpy(), ref, rtol=TOL[dtype], atol=TOL[dtype])


def _params(family, seed, d=3):
    rng = np.random.default_rng(seed)
    pos = lambda low=0.5, high=4.0: rng.uniform(low, high, size=SHAPE)  # noqa: E731
    if family == "NormalGamma":
        return {"m": rng.normal(size=SHAPE), "beta": pos(), "a": pos(1.0, 5.0), "b": pos()}
    if family == "Wishart":
        a = rng.normal(size=SHAPE + (d, d))
        return {"n": pos(d + 1.0, d + 6.0), "V": a @ np.swapaxes(a, -1, -2) + d * np.eye(d)}
    return {"log_rate": rng.normal(size=SHAPE)}


def _pair(family, seed, dtype):
    p = {k: np.asarray(v, dtype) for k, v in _params(family, seed).items()}
    port = getattr(P, family)(**{k: torch.from_numpy(v) for k, v in p.items()})
    ref = getattr(J, family)(**{k: jnp.asarray(v) for k, v in p.items()})
    return port, ref


CALLS = {
    "NormalGamma": ["mean_mu", "mean_tau", "mean_log_tau()", "entropy()",
                    "expected_tau_sq_diff(x)"],
    "Wishart": ["mean", "mean_logdet()", "log_normalizer()"],
    "Poisson": ["rate", "mean", "variance", "logpmf(k)"],
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", list(CALLS))
def test_moments_and_functions_match_jax(family, dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=SHAPE).astype(dtype)
    k = rng.integers(0, 6, size=SHAPE).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        port, ref = _pair(family, 0, dtype)
        for call in CALLS[family]:
            name, _, arg = call.partition("(")
            got, want = getattr(port, name), getattr(ref, name)
            if arg == ")":
                got, want = got(), want()
            elif arg:
                value = {"x)": x, "k)": k}[arg]
                got, want = got(torch.from_numpy(value)), want(jnp.asarray(value))
            _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", list(CALLS))
def test_product_and_kl_match_jax(family, dtype):
    with jax.enable_x64(dtype == np.float64):
        p, jp = _pair(family, 1, dtype)
        q, jq = _pair(family, 2, dtype)
        prod, jprod = p * q, jp * jq
        assert type(prod).__name__ == family
        for field in _params(family, 0):
            _close(getattr(prod, field), getattr(jprod, field), dtype)
        if hasattr(jp, "kl"):
            _close(p.kl(q), jp.kl(jq), dtype)
            _close(q.kl(p), jq.kl(jp), dtype)
            _close(p.kl(p), jp.kl(jp), dtype)
        if family == "Wishart":
            assert p.dim == jp.dim == 3


def test_normal_gamma_product_is_the_conjugate_posterior():
    """NG(prior) x NG(one-observation message) is the conjugate update
    (tests/test_dists_extra.py's case), in both packages."""
    t = lambda v: torch.tensor(float(v))  # noqa: E731
    prior, like = P.NormalGamma(t(0.0), t(1.0), t(1.5), t(1.0)), P.NormalGamma(t(2.0), t(1.0),
                                                                               t(1.0), t(0.0))
    post = prior * like
    jpost = J.NormalGamma(*map(jnp.asarray, (0.0, 1.0, 1.5, 1.0))) * J.NormalGamma(
        *map(jnp.asarray, (2.0, 1.0, 1.0, 0.0)))
    want = {"m": 1.0, "beta": 2.0, "a": 2.0, "b": 2.0}
    for field, value in want.items():
        assert float(getattr(post, field)) == pytest.approx(value, rel=1e-6)
        assert float(getattr(post, field)) == pytest.approx(float(getattr(jpost, field)),
                                                            rel=1e-6)


def test_wishart_product_halves_the_scale():
    w = P.Wishart(torch.tensor(4.0), 2.0 * torch.eye(2))
    prod = w * w
    assert float(prod.n) == pytest.approx(5.0)
    np.testing.assert_allclose(prod.V.numpy(), np.eye(2), rtol=1e-5)


def test_poisson_from_rate_matches_jax():
    p, jp = P.Poisson.from_rate(3.0, device="cpu"), J.Poisson.from_rate(3.0)
    assert p.log_rate.dtype == torch.float32
    _close(p.log_rate, jp.log_rate, np.float32)
    assert float((p * P.Poisson.from_rate(5.0, device="cpu")).rate) == pytest.approx(15.0,
                                                                                    rel=1e-5)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_normal_gamma_samples_have_the_conditional_structure():
    p = P.NormalGamma(*(torch.tensor(v) for v in (1.0, 2.0, 3.0, 2.0)))
    mu, tau = p.sample(_gen(2), (100_000,))
    assert mu.shape == tau.shape == (100_000,) and mu.dtype == torch.float32
    # tests/test_dists_extra.py's bars: E[tau] = a/b = 1.5, E[mu] = m = 1.
    assert float(tau.mean()) == pytest.approx(1.5, abs=0.02)
    assert float(mu.mean()) == pytest.approx(1.0, abs=0.02)
    # Var[mu | tau] = 1/(beta tau): the standardized residual has unit variance.
    z = (mu - 1.0) * torch.sqrt(2.0 * tau)
    assert float(z.var()) == pytest.approx(1.0, abs=0.02)
    assert p.sample(_gen(3), (2, 5))[0].shape == (2, 5)


def test_wishart_samples_match_the_mean_and_mean_logdet():
    V = torch.tensor([[2.0, 0.3], [0.3, 1.0]])
    w = P.Wishart(torch.full((20_000,), 5.0), V.expand(20_000, 2, 2))
    X = w.sample(_gen(3))
    assert X.shape == (20_000, 2, 2)
    np.testing.assert_allclose(X.mean(0).numpy(), 5.0 * V.numpy(), rtol=0.05)
    torch.testing.assert_close(X, X.transpose(-1, -2))
    mc = float(torch.linalg.slogdet(X.double())[1].mean())
    # tests/test_dists_extra.py's bar: E[log|X|] within 0.05 of Monte Carlo.
    assert float(w.mean_logdet()[0]) == pytest.approx(mc, abs=0.05)


def test_poisson_samples_match_the_kl_by_monte_carlo():
    p, q = P.Poisson.from_rate(3.0, device="cpu"), P.Poisson.from_rate(5.0, device="cpu")
    xs = p.sample(_gen(4), (200_000,))
    assert xs.shape == (200_000,) and xs.dtype == torch.int32
    assert float(xs.float().mean()) == pytest.approx(3.0, abs=0.02)
    assert float(xs.float().var()) == pytest.approx(3.0, abs=0.05)
    est = float((p.logpmf(xs) - q.logpmf(xs)).mean())
    assert float(p.kl(q)) == pytest.approx(est, abs=0.02)
    jp = J.Poisson.from_rate(3.0)
    _close(p.logpmf(xs[:50]), jp.logpmf(jnp.asarray(xs[:50].numpy())), np.float32)


@pytest.mark.parametrize("family", list(CALLS))
def test_dist_from_numpy_carries_the_family_across(family):
    _, ref = _pair(family, 3, np.float32)
    got = convert.dist_from_numpy(family, dataclasses.asdict(ref), device="cpu")
    assert type(got) is getattr(P, family)
    for field, value in dataclasses.asdict(ref).items():
        _close(getattr(got, field), value, np.float32)
    assert family in convert.DISTRIBUTIONS
