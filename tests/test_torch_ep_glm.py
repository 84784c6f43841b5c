"""Port parity: EP (``cortex_tpu_torch.ops.ep``), CVI (``ops.cvi``), the GLMs
(``models.glm``), ``models.EPClassifier`` and the AR family (``models.ar``)
against the JAX package.

The same numpy inputs go through both packages on the CPU (JAX under
``jax.jit``).  Bars, those of the JAX tests of each module:

- EP: Gaussian sites against the exact posterior, and every EP fit against
  JAX's: mean rtol 1e-4, atol 1e-5; cov rtol 1e-3, atol 1e-5
  (tests/test_ep.py); quadrature against the closed form: 2e-3.
- CVI: one ρ=1 step on Gaussian sites against the exact posterior: mean 1e-3,
  cov rtol 1e-2, atol 1e-4 (tests/test_cvi.py); the logistic fit against JAX's
  at the same bars, the ELBO trace rtol 1e-4.
- NIG (nig_fit, BayesianLinearRegression, BayesianAR) against float64 and JAX:
  mean 1e-3, cov_scale rtol 1e-2, atol 1e-6, a rtol 1e-6, b rtol 1e-2, log
  evidence rtol 1e-4 (tests/test_glm.py, tests/test_ar.py); the AR forecast
  rtol 1e-4, atol 1e-5.
- The latent AR against JAX's: mean rtol 1e-4, atol 1e-4; cov rtol 1e-3, atol
  1e-4 (tests/test_ar.py's latent bars).
- ``convert.fitted_from_numpy``: the JAX result carried across predicts what
  JAX predicts (rtol 1e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cortex_tpu_torch import convert, models, ops

import cortex_tpu.models as jmodels
import cortex_tpu.ops as jops

EP = dict(rtol=1e-4, atol=1e-5)
EP_COV = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them:
    an HMC test took 30 s under load against 4 s with one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol, atol=0.0):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _design(n=40, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng


def _probit_data(n=60, seed=1):
    X, rng = _design(n, 2, seed)
    y = np.where(X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0, 1.0, -1.0)
    return X, y.astype(np.float32)


def test_ep_gaussian_sites_recover_the_exact_posterior_as_jax():
    X, rng = _design()
    r = 0.3
    y = (X @ np.array([1.0, -0.5, 0.25]) + rng.normal(0, np.sqrt(r), size=40)).astype(np.float32)

    def tilted(yy):
        def moments(mu_cav, var_cav):
            v = 1.0 / (1.0 / var_cav + 1.0 / r)
            return v * (mu_cav / var_cav + yy / r), v
        return moments

    got = ops.ep_linear_model(_t(X), tilted(_t(y)), prior_var=2.0, n_iters=5, damping=1.0)
    want = jax.jit(lambda X, y: jops.ep_linear_model(X, tilted(y), prior_var=2.0, n_iters=5,
                                                     damping=1.0))(X, y)
    S = np.linalg.inv(np.eye(3) / 2.0 + X.T.astype(np.float64) @ X / r)
    _close(got.mean, S @ X.T @ y / r, **EP)
    _close(got.cov, S, **EP_COV)
    assert float(got.site_delta) < 1e-5
    for g, w in zip(got, want):
        _close(g, w, **EP_COV)


def test_ep_probit_and_quadrature_match_jax():
    X, y = _probit_data()
    got = ops.ep_linear_model(_t(X), ops.probit_tilted_moments(_t(y)))
    want = jax.jit(lambda X, y: jops.ep_linear_model(X, jops.probit_tilted_moments(y)))(X, y)
    _close(got.mean, want.mean, **EP)
    _close(got.cov, want.cov, **EP_COV)
    _close(got.site_tau, want.site_tau, **EP_COV)
    mu = np.linspace(-2.0, 2.0, 7).astype(np.float32)
    var = np.linspace(0.2, 3.0, 7).astype(np.float32)
    yq = np.where(np.arange(7) % 2, 1.0, -1.0).astype(np.float32)
    exact = ops.probit_tilted_moments(_t(yq))(_t(mu), _t(var))
    quad = ops.gauss_hermite_tilted(
        lambda z: torch.special.log_ndtr(_t(yq)[:, None] * z))(_t(mu), _t(var))
    jquad = jax.jit(jops.gauss_hermite_tilted(
        lambda z: jax.scipy.stats.norm.logcdf(yq[:, None] * z)))(mu, var)
    for e, q, jq in zip(exact, quad, jquad):
        _close(q, e.numpy(), rtol=0.0, atol=2e-3)
        _close(q, jq, rtol=1e-5, atol=1e-6)


def test_cvi_one_conjugate_step_is_exact():
    X, rng = _design(50, 3, 2)
    r = 0.5
    y = (X @ np.array([0.8, -0.3, 0.5]) + rng.normal(0, np.sqrt(r), size=50)).astype(np.float32)
    yt = _t(y)
    out = ops.cvi_linear_model(_t(X), lambda z: -0.5 * (yt[:, None] - z) ** 2 / r,
                               prior_var=1.0, n_iters=1, step_size=1.0)
    S = np.linalg.inv(np.eye(3) + X.T.astype(np.float64) @ X / r)
    _close(out.mean, S @ X.T @ y / r, rtol=1e-3, atol=1e-3)
    _close(out.cov, S, rtol=1e-2, atol=1e-4)
    assert out.elbo_trace.shape == (1,)


def test_cvi_logistic_matches_jax():
    X, y = _probit_data(80, 3)
    yt = _t(y)
    got = ops.cvi_linear_model(_t(X), lambda z: torch.nn.functional.logsigmoid(yt[:, None] * z),
                               n_iters=30)
    want = jax.jit(lambda X, y: jops.cvi_linear_model(
        X, lambda z: jax.nn.log_sigmoid(y[:, None] * z), n_iters=30))(X, y)
    _close(got.mean, want.mean, rtol=1e-3, atol=1e-3)
    _close(got.cov, want.cov, rtol=1e-2, atol=1e-4)
    _close(got.elbo_trace, want.elbo_trace, rtol=1e-4)
    assert np.all(np.diff(got.elbo_trace.numpy()[5:]) > -1e-3)


@pytest.fixture(scope="module")
def nig_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3, 200, 4)).astype(np.float32)
    t = (X @ rng.normal(size=4) + 0.3 * rng.normal(size=(3, 200))).astype(np.float32)
    return X, t


def test_nig_fit_matches_float64_and_jax(nig_data):
    X, t = nig_data
    got = models.nig_fit(_t(X), _t(t), prior_scale=25.0, a0=2.5, b0=0.5)
    want = jax.jit(lambda X, t: jmodels.nig_fit(X, t, prior_scale=25.0, a0=2.5, b0=0.5))(X, t)
    for b in range(3):
        Xb, tb = X[b].astype(np.float64), t[b].astype(np.float64)
        prec = np.eye(4) / 25.0 + Xb.T @ Xb
        Vn = np.linalg.inv(prec)
        mn = Vn @ (Xb.T @ tb)
        _close(got.mean[b], mn, rtol=1e-3, atol=1e-3)
        _close(got.cov_scale[b], Vn, rtol=1e-2, atol=1e-6)
        _close(got.b[b], 0.5 + 0.5 * (tb @ tb - mn @ prec @ mn), rtol=1e-2)
    for field, bar in (("mean", dict(rtol=1e-3, atol=1e-3)),
                       ("cov_scale", dict(rtol=1e-2, atol=1e-6)), ("a", dict(rtol=1e-6)),
                       ("b", dict(rtol=1e-2)), ("log_evidence", dict(rtol=1e-4))):
        _close(getattr(got, field), getattr(want, field), **bar)
    _close(got.noise_mean, want.noise_mean, rtol=1e-2)
    _close(got.coeff_cov, want.coeff_cov, rtol=1e-2, atol=1e-6)


def test_linear_regression_predictive_matches_jax(nig_data):
    X, t = nig_data
    Xs = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    model, jmodel = models.BayesianLinearRegression(), jmodels.BayesianLinearRegression()
    got = model.predictive(model.fit(_t(X[0]), _t(t[0])), _t(Xs))
    want = jax.jit(lambda X, t, Xs: jmodel.predictive(jmodel.fit(X, t), Xs))(X[0], t[0], Xs)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-4, atol=1e-5)


def test_poisson_regression_matches_jax():
    X, rng = _design(150, 2, 4)
    X *= 0.5
    y = rng.poisson(np.exp(X @ np.array([0.8, -0.5]) + 0.5)).astype(np.float32)
    got = models.PoissonRegression(n_iters=30).fit(_t(X), _t(y))
    want = jax.jit(lambda X, y: jmodels.PoissonRegression(n_iters=30).fit(X, y))(X, y)
    _close(got.mean, want.mean, **EP)
    _close(got.cov, want.cov, **EP_COV)
    _close(got.predict_rate(_t(X[:5])), want.predict_rate(X[:5]), rtol=1e-4)


def _jax_classifier(X, y, **kw):
    """JAX's EPClassifier fit, its arrays under ``jax.jit`` (the likelihood is
    a string)."""
    model = jmodels.EPClassifier(**kw)
    fields = jax.jit(lambda X, y: tuple(model.fit(X, y))[:3])(X, y)
    return jmodels.EPClassifierPosterior(*fields, model.likelihood)


@pytest.mark.parametrize("likelihood", ["probit", "logistic"])
def test_ep_classifier_matches_jax(likelihood):
    X, y = _probit_data(80, 5)
    got = models.EPClassifier(likelihood=likelihood, n_iters=20).fit(_t(X), _t(y))
    want = _jax_classifier(X, y, likelihood=likelihood, n_iters=20)
    _close(got.mean, want.mean, **EP)
    _close(got.cov, want.cov, **EP_COV)
    Xs = X[:10]
    _close(got.predict_proba(_t(Xs)), want.predict_proba(Xs), rtol=1e-4, atol=1e-5)
    _close(got.predict(_t(Xs)), want.predict(Xs), rtol=0.0)
    with pytest.raises(ValueError, match="unknown likelihood"):
        models.EPClassifier(likelihood="cauchit").fit(_t(X), _t(y))


def _simulate_ar(coeffs, T, seed, batch=()):
    rng = np.random.default_rng(seed)
    y = np.zeros(batch + (T,))
    for t in range(T):
        lags = sum(c * y[..., t - 1 - k] for k, c in enumerate(coeffs[:t]))
        y[..., t] = lags + 0.3 * rng.normal(size=batch)
    return y.astype(np.float32)


def test_bayesian_ar_fit_and_forecast_match_jax():
    y = _simulate_ar([0.6, -0.2, 0.1], 120, 0, (4,))
    model, jmodel = models.BayesianAR(p=3), jmodels.BayesianAR(p=3)
    got = model.fit(_t(y))
    want = jax.jit(jmodel.fit)(y)
    for field, bar in (("mean", dict(rtol=1e-3, atol=1e-3)),
                       ("cov_scale", dict(rtol=1e-2, atol=1e-6)), ("a", dict(rtol=1e-6)),
                       ("b", dict(rtol=1e-2)), ("log_evidence", dict(rtol=1e-4))):
        _close(getattr(got, field), getattr(want, field), **bar)
    _close(model.predict(_t(y), horizon=6), jax.jit(lambda y: jmodel.predict(y, horizon=6))(y),
           rtol=1e-4, atol=1e-5)
    _close(models.companion_matrix(torch.tensor([0.5, -0.2, 0.1])),
           jmodels.companion_matrix(jnp.asarray([0.5, -0.2, 0.1])), rtol=0.0)
    assert model.predict(_t(y), horizon=0).shape == (4, 0)


def test_latent_ar_smooth_matches_jax():
    coeffs = np.array([0.7, -0.2], np.float32)
    y = (_simulate_ar(list(coeffs), 40, 1, (3,))
         + 0.5 * np.random.default_rng(2).normal(size=(3, 40))).astype(np.float32)
    got = models.latent_ar_smooth(_t(y), _t(coeffs), 0.09, 0.25)
    want = jax.jit(lambda y, c: jmodels.latent_ar_smooth(y, c, 0.09, 0.25))(y, coeffs)
    _close(got.mean, want.mean, rtol=1e-4, atol=1e-4)
    _close(got.cov, want.cov, rtol=1e-3, atol=1e-4)


def _jax_fits():
    """One fitted result of each kind the converter takes, from JAX."""
    X, y = _probit_data(60, 7)
    Xp, rng = _design(60, 2, 8)
    counts = rng.poisson(np.exp(0.5 * Xp[:, 0])).astype(np.float32)
    yl = (X @ np.array([1.0, -1.0]) + 0.2 * rng.normal(size=60)).astype(np.float32)
    return {
        "NIGPosterior": jax.jit(jmodels.BayesianAR(p=2).fit)(_simulate_ar([0.5, 0.2], 50, 3)),
        "PoissonPosterior": jax.jit(jmodels.PoissonRegression(n_iters=10).fit)(Xp, counts),
        "EPResult": jax.jit(lambda X, y: jops.ep_linear_model(
            X, jops.probit_tilted_moments(y), n_iters=10))(X, y),
        "CVIResult": jax.jit(lambda X, y: jops.cvi_linear_model(
            X, lambda z: -0.5 * (y[:, None] - z) ** 2, n_iters=3))(X, yl),
        "EPClassifierPosterior": _jax_classifier(X, y, n_iters=10),
    }


def test_fitted_results_round_trip_through_numpy():
    fits = _jax_fits()
    Xs = np.random.default_rng(9).normal(size=(6, 2)).astype(np.float32)
    classes = {c.__name__: c for c in convert.FITTED}
    for name, fit in fits.items():
        port = convert.fitted_from_numpy(classes[name], fit, device="cpu")
        assert type(port).__name__ == name
        for field, got, want in zip(port._fields, port, fit):
            if field == "ep":
                for g, w in zip(got, want):
                    _close(g, w, rtol=0.0)
            elif field == "likelihood":
                assert got == want
            else:
                _close(got, want, rtol=0.0)
    ar = convert.fitted_from_numpy(models.ARPosterior, fits["NIGPosterior"], device="cpu")
    _close(ar.noise_mean, fits["NIGPosterior"].noise_mean, rtol=1e-5)
    pois = convert.fitted_from_numpy(models.PoissonPosterior, fits["PoissonPosterior"],
                                     device="cpu")
    _close(pois.predict_rate(_t(Xs)), fits["PoissonPosterior"].predict_rate(Xs), rtol=1e-5)
    clf = convert.fitted_from_numpy(models.EPClassifierPosterior,
                                    fits["EPClassifierPosterior"], device="cpu")
    _close(clf.predict_proba(_t(Xs)), fits["EPClassifierPosterior"].predict_proba(Xs), rtol=1e-5)
    with pytest.raises(ValueError, match="fields"):
        convert.fitted_from_numpy(models.NIGPosterior, list(fits["NIGPosterior"])[:4],
                                  device="cpu")
    with pytest.raises(ValueError, match="not a fitted result"):
        convert.fitted_from_numpy(dataclasses.make_dataclass("Other", []), (), device="cpu")
