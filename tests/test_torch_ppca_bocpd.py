"""Port parity: PPCA and factor analysis (``cortex_tpu_torch.models.ppca``) and
BOCPD (``models.bocpd``) against the JAX package.

The same numpy inputs go through both packages on the CPU (JAX under
``jax.jit``).  Eigenvector and QR signs differ between libraries, so the
loadings are compared as ``W Wᵀ``, never ``W``.  JAX's default EM start
draws from ``PRNGKey(seed)``; the parity tests pass the start (``init``),
which for factor analysis is JAX's own start, computed here by the same
steps.  Bars:

- PPCA's closed form against the float64 oracle: σ² rtol 1e-4, log
  likelihood rtol 1e-5 (tests/test_ppca.py); against JAX: W Wᵀ, σ² and the
  log likelihood rtol 1e-4, atol 1e-5; EM from the same start against JAX:
  the same bars on W Wᵀ, σ²/ψ and the trace; EM traces non-decreasing up to
  -0.5; the EM subspace against the closed form's within 5e-3
  (tests/test_ppca.py).
- BOCPD against JAX: log run-length probabilities of non-negligible mass
  (above -25), changepoint probabilities and log evidence rtol 1e-5, atol
  1e-6; against the untruncated float64 oracle (r_max > T): 2e-3 on the mass
  above -25 (tests/test_bocpd.py); batched against single series rtol 1e-5,
  atol 1e-6; truncated mass sums to 1 at rtol 1e-4.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cortex_tpu_torch import convert, models

import cortex_tpu.models as jmodels

REPO = Path(__file__).resolve().parents[1]
BAR = dict(rtol=1e-4, atol=1e-5)


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


def _wwt(W):
    W = np.asarray(W.detach() if isinstance(W, torch.Tensor) else W, np.float64)
    return W @ W.T


@pytest.fixture(scope="module")
def synth():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(12, 3)) * np.array([3.0, 2.0, 1.0])
    Y = rng.normal(size=(500, 3)) @ W.T + rng.normal(scale=0.5, size=(500, 12)) + 5.0
    psi = rng.uniform(0.05, 2.0, size=12)
    Y_fa = rng.normal(size=(500, 3)) @ W.T + np.sqrt(psi) * rng.normal(size=(500, 12))
    return Y.astype(np.float32), Y_fa.astype(np.float32), psi


def test_ppca_closed_form_matches_the_oracle_and_jax(synth):
    Y = synth[0]
    got = models.ppca_closed_form(_t(Y), 3)
    want = jax.jit(lambda Y: jmodels.ppca_closed_form(Y, 3))(Y)
    Yc = Y.astype(np.float64) - Y.mean(0)
    evals = np.linalg.eigvalsh(Yc.T @ Yc / len(Y))
    s2 = evals[:9].mean()
    ll = -0.5 * len(Y) * (12 * np.log(2 * np.pi) + np.log(evals[-3:]).sum() + 9 * np.log(s2) + 12)
    assert float(got.sigma2) == pytest.approx(s2, rel=1e-4)
    assert float(got.log_likelihood) == pytest.approx(ll, rel=1e-5)
    np.testing.assert_allclose(_wwt(got.W), _wwt(want.W), **BAR)
    for field in ("sigma2", "mu", "log_likelihood"):
        _close(getattr(got, field), getattr(want, field), **BAR)
    with pytest.raises(ValueError, match="0 < q < d"):
        models.ppca_closed_form(_t(Y), 12)


def test_ppca_em_from_the_same_start_matches_jax(synth):
    Y = synth[0]
    cf = models.ppca_closed_form(_t(Y), 3)
    init = (0.5 * np.asarray(cf.W) + 0.1, np.float32(2.0))
    got = models.PPCA(3).fit_em(_t(Y), n_iters=30, init=(_t(init[0]), _t(init[1])))
    want = jax.jit(lambda Y, W0, s0: jmodels.PPCA(3).fit_em(Y, n_iters=30, init=(W0, s0)))(
        Y, *init)
    np.testing.assert_allclose(_wwt(got.W), _wwt(want.W), **BAR)
    _close(got.sigma2, want.sigma2, **BAR)
    _close(got.log_likelihood, want.log_likelihood, **BAR)
    assert np.all(np.diff(got.log_likelihood.numpy()) > -0.5)
    model = models.PPCA(3)
    ported = convert.fitted_from_numpy(models.PPCAResult, want, device="cpu")
    jmodel = jmodels.PPCA(3)
    for g, w in zip(model.transform(_t(Y[:7]), ported), jmodel.transform(Y[:7], want)):
        _close(g, w, rtol=1e-5, atol=1e-6)
    _close(model.log_likelihood(_t(Y), ported), jmodel.log_likelihood(Y, want), rtol=1e-5)


def test_ppca_em_default_start_finds_the_closed_form_subspace(synth):
    Y = synth[0]
    em = models.PPCA(3).fit_em(_t(Y), n_iters=60)
    again = models.PPCA(3).fit_em(_t(Y), n_iters=60, key=torch.Generator().manual_seed(0))
    assert torch.equal(em.W, again.W)  # key=None is a CPU generator seeded with 0
    cf = models.ppca_closed_form(_t(Y), 3)

    def projector(W):
        Q, _ = np.linalg.qr(np.asarray(W, np.float64))
        return Q @ Q.T

    np.testing.assert_allclose(projector(em.W), projector(cf.W), atol=5e-3)
    assert float(em.sigma2) == pytest.approx(float(cf.sigma2), rel=1e-2)
    assert np.all(np.diff(em.log_likelihood.numpy()) > -0.5)


def _jax_fa_start(Y, q, seed=0):
    """The start of JAX's FactorAnalysis.fit_em, by its own steps."""
    Y = jnp.asarray(Y)
    n, d = Y.shape
    Yc = Y - Y.mean(axis=0)
    diag_ss = jnp.sum(Yc * Yc, axis=0) / n
    omega = jax.random.normal(jax.random.PRNGKey(seed), (d, q), Y.dtype)
    Q, _ = jnp.linalg.qr(Yc.T @ (Yc @ omega) / n)
    lam = jnp.sum((Yc @ Q) ** 2, axis=0) / n
    iso = jnp.maximum((diag_ss.sum() - lam.sum()) / (d - q), 1e-6)
    W0 = Q * jnp.sqrt(jnp.maximum(lam - iso, 1e-6))
    return W0, jnp.maximum(diag_ss - jnp.sum(W0 * W0, axis=1), 0.05 * diag_ss)


def test_factor_analysis_from_jax_start_matches_jax(synth):
    Y = synth[1]
    W0, psi0 = jax.jit(_jax_fa_start, static_argnums=1)(Y, 3)
    got = models.FactorAnalysis(3).fit_em(_t(Y), n_iters=40, init=(_t(W0), _t(psi0)))
    want = jax.jit(lambda Y: jmodels.FactorAnalysis(3).fit_em(Y, n_iters=40))(Y)
    np.testing.assert_allclose(_wwt(got.W), _wwt(want.W), **BAR)
    _close(got.psi, want.psi, **BAR)
    _close(got.log_likelihood, want.log_likelihood, **BAR)
    assert np.all(np.diff(got.log_likelihood.numpy()) > -0.5)
    assert np.corrcoef(got.psi.numpy(), synth[2])[0, 1] > 0.9
    ported = convert.fitted_from_numpy(models.FAResult, want, device="cpu")
    for g, w in zip(ported, want):
        _close(g, w, rtol=0.0)
    with pytest.raises(ValueError, match="0 < q < d"):
        models.FactorAnalysis(12).fit_em(_t(Y))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _changes(seed, R=3, T=120):
    rng = np.random.default_rng(seed)
    level = np.cumsum((rng.random((R, T)) < 1 / 40) * rng.normal(scale=4.0, size=(R, T)), -1)
    gauss = (level + rng.normal(size=(R, T))).astype(np.float32)
    rate = 1 / (1 + np.exp(-np.cumsum((rng.random((R, T)) < 1 / 40)
                                     * rng.normal(scale=3.0, size=(R, T)), -1)))
    return gauss, (rng.random((R, T)) < rate).astype(np.float32)


@pytest.mark.parametrize("obs", ["gaussian", "bernoulli"])
def test_bocpd_matches_jax_and_the_float64_filter(obs):
    y = _changes(0)[0 if obs == "gaussian" else 1]

    def model(lib, r_max):
        obs_model = lib.GaussianNIG() if obs == "gaussian" else lib.BernoulliBeta()
        return lib.BOCPD(obs_model=obs_model, hazard=0.02, r_max=r_max)

    for r_max in (48, 160):  # truncated (the last bin merges), and exact
        got = model(models, r_max).filter(_t(y))
        want = jax.jit(model(jmodels, r_max).filter)(y)
        mass = np.asarray(want.run_length_logprobs) > -25.0
        _close(got.run_length_logprobs[torch.from_numpy(mass)],
               np.asarray(want.run_length_logprobs)[mass], rtol=1e-5, atol=1e-6)
        _close(got.changepoint_prob, want.changepoint_prob, rtol=1e-5, atol=1e-6)
        _close(got.log_evidence, want.log_evidence, rtol=1e-5)
        assert np.mean(got.map_run_length.numpy() == np.asarray(want.map_run_length)) > 0.99
        total = torch.exp(got.run_length_logprobs.double()).sum(-1)
        _close(total, np.ones(y.shape), rtol=1e-4)
    # With r_max > T the filter is exact: the float64 filter of chip_smoke.
    logp, cp, log_z = _chip_smoke().numpy_bocpd(y, obs, hazard=0.02, r_max=160)
    mass = logp > -25.0
    _close(got.run_length_logprobs[torch.from_numpy(mass)], logp[mass], rtol=2e-3, atol=2e-3)
    _close(got.log_evidence, log_z, rtol=1e-5)


def test_bocpd_batches_over_replicas():
    y = _changes(1)[0]
    batched = models.BOCPD(hazard=0.02, r_max=80).filter(_t(y))
    solo = models.BOCPD(hazard=0.02, r_max=80).filter(_t(y[1]))
    assert batched.run_length_logprobs.shape == (3, 120, 80)
    _close(solo.changepoint_prob, batched.changepoint_prob[1].numpy(), rtol=1e-5, atol=1e-6)
    _close(solo.log_evidence, batched.log_evidence[1].numpy(), rtol=1e-5)
