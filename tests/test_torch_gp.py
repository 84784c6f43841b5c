"""Port parity: the Gaussian processes (``cortex_tpu_torch.models.gp``,
``sgp``, ``gpc``, ``gp_ssm``) against the JAX package.

The same numpy inputs go through both packages on the CPU (JAX under
``jax.jit`` where it returns arrays; the fits that return closures run
eagerly).  Bars, those of the JAX tests of each module:

- GP posterior against the dense float64 formula and JAX: mean rtol 1e-3,
  atol 1e-4; variance rtol 1e-2, atol 1e-4; the LML rtol 1e-4 (tests/test_gp.py);
  kernels rtol 1e-5; ``fit_gp_ml`` and ``fit_gpssm_ml``'s loss traces and
  fitted hyperparameters against JAX's: rtol 1e-4 (both run Adam with
  optax's defaults).
- SGPR against JAX: the bound, a difference of terms of the size of yᵀy/σ²,
  within 1e-5 of that size (float32 on the terms); predictions as the GP's;
  with the inducing set equal to the inputs it recovers the exact GP
  (tests/test_sgp.py: |Δ| < 5% + 0.5, predictions 2e-2) and never exceeds it.
  ``fit_sgpr_ml`` draws its inducing start from a torch generator: the data
  are permuted so that the port's pick lands on JAX's points (the bound does
  not depend on the data's order), then the loss traces agree within the
  bound's bar and the inducing points at rtol 1e-3, atol 1e-4.
- GPClassifier against JAX: tests/test_ep.py's EP bars, latent mean rtol 1e-4,
  atol 1e-5; site precisions and probabilities rtol 1e-3, atol 1e-5.
- GPSSM against the exact GP and JAX: mean rtol 1e-3, atol 1e-4; variance
  rtol 2e-3, atol 1e-4; LML rtol 1e-4 (tests/test_gp_ssm.py); the
  discretization rtol 1e-5, atol 1e-6.
- ``convert.gp_posterior_from_numpy``: a JAX posterior's arrays carried
  across predict what JAX predicts: rtol 1e-5, atol 1e-6.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cortex_tpu_torch import convert, models
from cortex_tpu_torch.models import gp as tgp

import cortex_tpu.models as jmodels
from cortex_tpu.models import gp as jgp
from cortex_tpu.models import gp_ssm as jgp_ssm

GP_MEAN = dict(rtol=1e-3, atol=1e-4)
GP_VAR = dict(rtol=1e-2, atol=1e-4)


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


def _data(n=30, seed=0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


XS = np.linspace(-3, 3, 17, dtype=np.float32)[:, None]


def _jit(fn, *args):
    """``fn(*args)`` under ``jax.jit``: JAX's eager operations compile one by
    one, which costs seconds on the CPU."""
    return jax.jit(fn)(*args)


@pytest.mark.parametrize("kernel", ["rbf", "matern32", "matern52"])
def test_gp_posterior_matches_the_dense_formula_and_jax(kernel):
    X, y = _data()
    hyp = dict(kernel=kernel, lengthscale=0.8, variance=1.3, noise=0.05)
    post = models.GP(**hyp).fit(_t(X), _t(y))
    mean, var = post.predict(_t(XS))
    jmean, jvar, jlml = _jit(lambda X, y: (*jmodels.GP(**hyp).fit(X, y).predict(XS),
                                           jmodels.GP(**hyp).fit(X, y).lml), X, y)
    _close(mean, jmean, **GP_MEAN)
    _close(var, jvar, **GP_VAR)
    _close(post.lml, jlml, rtol=1e-4)
    k = {"rbf": jgp.rbf_kernel, "matern32": jgp.matern32_kernel,
         "matern52": jgp.matern52_kernel}[kernel]
    _close(tgp._KERNELS[kernel](_t(X), _t(XS), 0.8, 1.3), k(X, XS, 0.8, 1.3), rtol=1e-5,
           atol=1e-7)
    if kernel == "rbf":
        K = np.asarray(k(X, X, 0.8, 1.3), np.float64) + (0.05 + 1e-6) * np.eye(len(X))
        Ks = np.asarray(k(X, XS, 0.8, 1.3), np.float64)
        _close(mean, Ks.T @ np.linalg.solve(K, y), **GP_MEAN)
        _close(var, 1.3 - np.sum(Ks * np.linalg.solve(K, Ks), 0), **GP_VAR)


def test_gp_lml_gradient_and_ml_fit_match_jax():
    X, y = _data(40, 1)
    log_ell = torch.tensor(-0.2, requires_grad=True)
    models.GP(lengthscale=torch.exp(log_ell)).log_marginal_likelihood(_t(X), _t(y)).backward()
    want = jax.jit(jax.grad(lambda a: jmodels.GP(lengthscale=jnp.exp(a)).log_marginal_likelihood(
        X, y)))(jnp.asarray(-0.2))
    _close(log_ell.grad, want, rtol=1e-4)
    gp, losses = models.fit_gp_ml(_t(X), _t(y), n_steps=20)
    jgp_fit, jlosses = jmodels.fit_gp_ml(X, y, n_steps=20)
    _close(losses, jlosses, rtol=1e-4)
    for field in ("lengthscale", "variance", "noise"):
        assert getattr(gp, field) == pytest.approx(getattr(jgp_fit, field), rel=1e-4)


def _bound_bar(y, noise):
    """The collapsed bound is a difference of terms of the size of yᵀy/σ²
    (about 700 here against a bound of about 8): float32 holds it to about
    1e-5 of that size, not to a share of the difference."""
    return 1e-5 * float(np.sum(np.square(y, dtype=np.float64))) / noise


def test_sgpr_matches_jax_and_recovers_the_exact_gp():
    X, y = _data(60, 2)
    Z = X[::4]
    hyp = dict(kernel="rbf", lengthscale=0.8, variance=1.2, noise=0.05)
    post = models.SGPR(**hyp).fit(_t(X), _t(y), _t(Z))

    def jax_sgpr(X, y, Z):
        jpost = jmodels.SGPR(**hyp).fit(X, y, Z)
        return (jpost.elbo, *jpost.predict(XS))

    jelbo, *jpred = _jit(jax_sgpr, X, y, Z)
    _close(post.elbo, jelbo, rtol=0.0, atol=_bound_bar(y, hyp["noise"]))
    for g, w, bar in zip(post.predict(_t(XS)), jpred, (GP_MEAN, GP_VAR)):
        _close(g, w, **bar)
    exact = models.GP(**hyp).fit(_t(X), _t(y))
    assert float(post.elbo) <= float(exact.lml) + 1e-3
    full = models.SGPR(**hyp).fit(_t(X), _t(y), _t(X), jitter=1e-5)
    assert abs(float(full.elbo) - float(exact.lml)) < 0.05 * abs(float(exact.lml)) + 0.5
    for g, w in zip(full.predict(_t(XS)), exact.predict(_t(XS))):
        _close(g, w.numpy(), rtol=0.0, atol=2e-2)


def test_fit_sgpr_ml_matches_jax_from_the_same_inducing_start():
    X, y = _data(50, 3)
    m = 8
    jax_pick = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), len(X))[:m])
    port_pick = torch.randperm(len(X), generator=torch.Generator().manual_seed(0))[:m].numpy()
    # A permutation of the data that puts JAX's picks where the port picks.
    perm = np.empty(len(X), int)
    perm[port_pick] = jax_pick
    rest = np.setdiff1d(np.arange(len(X)), port_pick)
    perm[rest] = np.setdiff1d(np.arange(len(X)), jax_pick)
    model, Z, losses = models.fit_sgpr_ml(_t(X[perm]), _t(y[perm]), n_inducing=m, n_steps=15)
    jmodel, jZ, jlosses = jmodels.fit_sgpr_ml(X, y, n_inducing=m, n_steps=15)
    _close(losses, jlosses, rtol=0.0, atol=_bound_bar(y, float(np.var(y)) / 10))
    _close(Z, jZ, rtol=1e-3, atol=1e-4)
    assert model.lengthscale == pytest.approx(jmodel.lengthscale, rel=1e-3)


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_gp_classifier_matches_jax(kernel):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(60, 2)).astype(np.float32)
    y = np.where(np.sin(2 * X[:, 0]) + 0.5 * X[:, 1] > 0, 1.0, -1.0).astype(np.float32)
    model = dict(kernel=kernel, n_iters=20, variance=1.0 if kernel == "rbf" else 0.5)
    post = models.GPClassifier(**model).fit(_t(X), _t(y))

    def jax_gpc(X, y):
        jpost = jmodels.GPClassifier(**model).fit(X, y)
        return (jpost.latent_mean, jpost.site_tau, *jpost.latent(XS.repeat(2, 1)),
                jpost.predict_proba(X), jpost.predict(X))

    want = _jit(jax_gpc, X, y)
    got = (post.latent_mean, post.site_tau, *post.latent(_t(XS.repeat(2, 1))),
           post.predict_proba(_t(X)), post.predict(_t(X)))
    _close(got[0], want[0], rtol=1e-4, atol=1e-5)
    for g, w in zip(got[1:5], want[1:5]):
        _close(g, w, rtol=1e-3, atol=1e-5)
    _close(got[5], want[5], rtol=0.0)


def _ssm_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 10.0, size=n)).astype(np.float32)
    return t, (np.sin(t) + 0.3 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("kernel", ["matern12", "matern32", "matern52"])
def test_gpssm_matches_jax_and_the_exact_gp(kernel):
    t, y = _ssm_data()
    hyp = dict(lengthscale=1.3, variance=1.7, noise=0.2)
    got = models.GPSSM(kernel=kernel, **hyp).posterior(_t(t), _t(y))
    want = jax.jit(lambda t, y: jmodels.GPSSM(kernel=kernel, **hyp).posterior(t, y))(t, y)
    _close(got.mean, want.mean, rtol=1e-3, atol=1e-4)
    _close(got.variance, want.variance, rtol=2e-3, atol=1e-4)
    _close(got.log_marginal_likelihood, want.log_marginal_likelihood, rtol=1e-4)
    for g, w in zip(models.matern_state_space(kernel, 1.3, 1.7, _t(np.diff(t))),
                    jgp_ssm.matern_state_space(kernel, 1.3, 1.7, np.diff(t))):
        _close(g, w, rtol=1e-5, atol=1e-6)
    if kernel != "matern12":
        dense = models.GP(kernel=kernel, **hyp).fit(_t(t[:, None]), _t(y), jitter=0.0)
        mean, var = dense.predict(_t(t[:, None]))
        _close(got.mean, mean.numpy(), rtol=1e-3, atol=1e-4)
        _close(got.variance, var.numpy(), rtol=2e-3, atol=1e-4)
        _close(got.log_marginal_likelihood, dense.lml.numpy(), rtol=1e-4)


def test_gpssm_fit_matches_jax_and_rejects_unsorted_inputs():
    t, y = _ssm_data(40, 1)
    model, losses = models.fit_gpssm_ml(_t(t), _t(y), n_iters=10)
    jmodel, jlosses = jmodels.fit_gpssm_ml(t, y, n_iters=10)
    _close(losses, jlosses, rtol=1e-4)
    assert model.lengthscale == pytest.approx(jmodel.lengthscale, rel=1e-4)
    with pytest.raises(ValueError, match="sorted"):
        models.GPSSM().posterior(_t(t[::-1].copy()), _t(y))
    with pytest.raises(ValueError, match="sorted"):
        models.fit_gpssm_ml(_t(t[::-1].copy()), _t(y))
    with pytest.raises(ValueError, match="unknown Markovian kernel"):
        models.matern_state_space("rbf", 1.0, 1.0, _t(np.diff(t)))


def test_gp_posteriors_round_trip_through_numpy():
    X, y = _data(40, 5)
    yc = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    Z = X[::5]
    cases = [
        (models.GPPosterior, jmodels.GP(kernel="matern32", lengthscale=0.7),
         lambda m: m.fit(X, y), lambda post, c: dict(X=c["X"], alpha=c["alpha"], L=c["L"],
                                                      lml=post.lml)),
        (models.SGPRPosterior, jmodels.SGPR(lengthscale=0.9),
         lambda m: m.fit(X, y, Z), lambda post, c: dict(Z=c["Z"], L=c["L"], LB=c["LB"],
                                                         c=c["c"], elbo=post.elbo)),
        (models.GPCPosterior, jmodels.GPClassifier(n_iters=10),
         lambda m: m.fit(X, yc), lambda post, c: dict(
             X=c["X"], tau=post.site_tau, nu=post.site_nu, latent_mean=post.latent_mean,
             L=c["L"], alpha=c["alpha"], delta=post.site_delta)),
    ]
    for cls, jmodel, fit, arrays in cases:
        def jax_fit(X):
            """The arrays the JAX posterior's predictor closes over, and its
            predictions, under one jit."""
            jpost = fit(jmodel)
            predictor = jpost[-2 if cls is models.GPCPosterior else 0]
            return arrays(jpost, inspect.getclosurevars(predictor).nonlocals), predictor(XS)

        found, want = _jit(jax_fit, X)
        port = convert.gp_posterior_from_numpy(cls, dataclasses.asdict(jmodel), found,
                                               device="cpu")
        assert isinstance(port, cls)
        got = port.latent(_t(XS)) if cls is models.GPCPosterior else port.predict(_t(XS))
        for g, w in zip(got, want):
            _close(g, w, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="not a GP posterior"):
        convert.gp_posterior_from_numpy(models.GPSSMPosterior, {}, {}, device="cpu")
