"""Port parity: the nonlinear state-space sweeps (``cortex_tpu_torch.ops.nonlinear``,
``models.NonlinearSSM``) against the JAX package.

The same numpy inputs go through both packages on the CPU (JAX under
``jax.jit``: its eager scans cost seconds a call).  JAX's random draws cannot
be made in torch, so the parity tests feed JAX-sampled series.  Bars, those of
tests/test_nlssm.py:

- EKF and UKF, filter and smooth, against JAX on the same series: rtol 1e-4,
  atol 1e-5 on means and covariances, rtol 1e-4 on the log evidence;
- linear ``f``, ``h`` against the exact Kalman filter and RTS smoother: the
  same bars;
- EKF and UKF on a linear multivariate model agree: rtol 1e-3, atol 1e-4;
- the nonlinear observation model against a dense-grid Bayes filter: means
  0.08, variances 0.04;
- batched replicas against single-chain calls: rtol 1e-5, atol 1e-6;
- the gradient of the log evidence against JAX's: rtol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cortex_tpu_torch import convert, models, ops
from cortex_tpu_torch.models import NonlinearSSM

import cortex_tpu.models as jmodels
import cortex_tpu.ops as jops

DT = 0.05
PENDULUM = dict(Q=0.01 * np.eye(2, dtype=np.float32), R=np.array([[0.05]], np.float32),
                m0=np.array([0.5, 0.0], np.float32), P0=0.1 * np.eye(2, dtype=np.float32))
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


def _pendulum_jax():
    return jmodels.NonlinearSSM(
        f=lambda x: jnp.array([x[0] + DT * x[1], x[1] - DT * 9.81 * jnp.sin(x[0])]),
        h=lambda x: jnp.array([jnp.sin(x[0])]),
        **{k: jnp.asarray(v) for k, v in PENDULUM.items()})


def _pendulum_port():
    return convert.nlssm_from_numpy(
        PENDULUM,
        f=lambda x: torch.stack([x[0] + DT * x[1], x[1] - DT * 9.81 * torch.sin(x[0])]),
        h=lambda x: torch.sin(x[:1]),
        device="cpu")


@pytest.fixture(scope="module")
def pendulum_series():
    _, ys = jax.jit(lambda k: _pendulum_jax().sample(k, T=40, batch_shape=(4,)))(
        jax.random.PRNGKey(3))
    return np.asarray(ys)


def _close(got, want, rtol, atol=0.0):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("method", ["ekf", "ukf"])
def test_pendulum_filter_and_smoother_match_jax(pendulum_series, method):
    model, y = _pendulum_port(), torch.from_numpy(pendulum_series)
    wants = jax.jit(lambda y: (_pendulum_jax().filter(y, method=method),
                               _pendulum_jax().smooth(y, method=method)))(pendulum_series)
    for got, want in zip((model.filter(y, method=method), model.smooth(y, method=method)), wants):
        for g, w in zip(got, want):
            _close(g, w, **BAR)
        assert got.mean.shape == (4, 40, 2)


def _linear(A=0.9, Q=0.3, H=1.2, R=0.5, m0=0.4, P0=1.3):
    return NonlinearSSM(f=lambda x: A * x, h=lambda x: H * x, Q=torch.tensor([[Q]]),
                        R=torch.tensor([[R]]), m0=torch.tensor([m0]), P0=torch.tensor([[P0]]))


def _walk(T, seed, shape=()):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape + (T, 1)).cumsum(axis=-2).astype(np.float32)


@pytest.mark.parametrize("method", ["ekf", "ukf"])
def test_linear_limit_matches_the_kalman_filter_and_rts(method):
    A, Q, H, R, m0, P0 = 0.9, 0.3, 1.2, 0.5, 0.4, 1.3
    y = torch.from_numpy(_walk(40, 0))
    exact = models.LGSSM(A=A, Q=Q, H=H, R=R)
    prior = (torch.tensor(m0), torch.tensor(P0))
    model = _linear(A, Q, H, R, m0, P0)
    for got, want in ((model.filter(y, method=method), exact.filter(y[:, 0], prior=prior)),
                      (model.smooth(y, method=method), exact.smooth(y[:, 0], prior=prior))):
        _close(got.mean[:, 0], want.mean.numpy(), **BAR)
        _close(got.cov[:, 0, 0], want.variance.numpy(), **BAR)
    _close(model.log_evidence(y, method=method),
           exact.log_evidence(y[:, 0], prior=prior).numpy(), rtol=1e-4)


def test_multivariate_linear_ekf_and_ukf_agree_and_match_jax():
    d, m, T = 3, 2, 25
    rng = np.random.default_rng(2)
    A = (0.5 * rng.normal(size=(d, d))).astype(np.float32)
    H = rng.normal(size=(m, d)).astype(np.float32)
    Q, R = 0.2 * np.eye(d, dtype=np.float32), 0.3 * np.eye(m, dtype=np.float32)
    m0, P0 = np.zeros(d, np.float32), np.eye(d, dtype=np.float32)
    y = rng.normal(size=(T, m)).astype(np.float32)
    At, Ht = torch.from_numpy(A), torch.from_numpy(H)
    args = [torch.from_numpy(a) for a in (Q, R, y, m0, P0)]
    e = ops.ekf_smooth(lambda x: At @ x, lambda x: Ht @ x, *args)
    u = ops.ukf_smooth(lambda x: At @ x, lambda x: Ht @ x, *args)
    _close(e.mean, u.mean.numpy(), rtol=1e-3, atol=1e-4)
    _close(e.cov, u.cov.numpy(), rtol=1e-3, atol=1e-4)
    _close(e.loglik, u.loglik.numpy(), rtol=1e-4)
    Aj, Hj = jnp.asarray(A), jnp.asarray(H)
    want = jax.jit(lambda *a: jops.ukf_smooth(lambda x: Aj @ x, lambda x: Hj @ x, *a))(
        Q, R, y, m0, P0)
    for g, w in zip(u, want):
        _close(g, w, **BAR)


def _grid_filter(y, a, q, h_fn, r, m0, p0, lo=-8.0, hi=8.0, n=1601):
    """Numerically exact 1-D Bayes filter on a dense grid (the oracle)."""
    x = np.linspace(lo, hi, n)
    dx = x[1] - x[0]
    trans = np.exp(-0.5 * (x[None, :] - a * x[:, None]) ** 2 / q)  # [from, to]
    trans /= trans.sum(axis=1, keepdims=True)
    p = np.exp(-0.5 * (x - m0) ** 2 / p0)
    means, varis = [], []
    for t in range(y.shape[0]):
        p = p * np.exp(-0.5 * (y[t] - h_fn(x)) ** 2 / r)
        p /= p.sum() * dx
        mu = np.sum(x * p) * dx
        means.append(mu)
        varis.append(np.sum((x - mu) ** 2 * p) * dx)
        p = p @ trans
    return np.array(means), np.array(varis)


def test_nonlinear_observation_matches_the_grid_oracle():
    a, q, r, m0, p0 = 0.9, 0.2, 0.4, 0.0, 0.5
    rng = np.random.default_rng(3)
    xs = [rng.normal(m0, np.sqrt(p0))]
    for _ in range(29):
        xs.append(a * xs[-1] + rng.normal(0, np.sqrt(q)))
    y = np.array(xs) + 0.5 * np.sin(np.array(xs)) + rng.normal(0, np.sqrt(r), size=30)
    grid_mean, grid_var = _grid_filter(y, a, q, lambda x: x + 0.5 * np.sin(x), r, m0, p0)
    model = NonlinearSSM(f=lambda x: a * x, h=lambda x: x + 0.5 * torch.sin(x),
                         Q=torch.tensor([[q]]), R=torch.tensor([[r]]), m0=torch.tensor([m0]),
                         P0=torch.tensor([[p0]]))
    for method in ("ekf", "ukf"):
        beliefs = model.filter(torch.tensor(y, dtype=torch.float32)[:, None], method=method)
        _close(beliefs.mean[:, 0], grid_mean, rtol=0.0, atol=0.08)
        _close(beliefs.cov[:, 0, 0], grid_var, rtol=0.0, atol=0.04)


def test_batched_replicas_match_single_chains_and_smoothing_tightens():
    model = _linear()
    y = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 4, 20, 1)).astype(np.float32))
    batched = model.smooth(y, method="ukf")
    assert batched.mean.shape == (3, 4, 20, 1) and batched.cov.shape == (3, 4, 20, 1, 1)
    assert batched.loglik.shape == (3, 4)
    single = model.smooth(y[1, 2], method="ukf")
    _close(batched.mean[1, 2], single.mean.numpy(), rtol=1e-5, atol=1e-6)
    _close(batched.loglik[1, 2], single.loglik.numpy(), rtol=1e-5)
    filtered = model.filter(y[0, 0], method="ukf")
    assert torch.all(single.cov[:-1, 0, 0] <= filtered.cov[:-1, 0, 0] + 1e-6)
    _close(model.smooth(y[0, 0], method="ukf").mean[-1], filtered.mean[-1].numpy(), rtol=1e-5)


def test_log_evidence_gradient_matches_jax():
    y = _walk(25, 6)

    def jax_nll(log_a):
        a = jnp.exp(log_a)
        return -jops.ukf_filter(lambda x: a * x, lambda x: x + 0.1 * jnp.tanh(x),
                                jnp.array([[0.3]]), jnp.array([[0.5]]), y, jnp.array([0.0]),
                                jnp.array([[1.0]])).loglik

    want = jax.jit(jax.grad(jax_nll))(jnp.asarray(-0.2))
    log_a = torch.tensor(-0.2, requires_grad=True)
    a = torch.exp(log_a)
    nll = -ops.ukf_filter(lambda x: a * x, lambda x: x + 0.1 * torch.tanh(x),
                          torch.tensor([[0.3]]), torch.tensor([[0.5]]), torch.from_numpy(y),
                          torch.tensor([0.0]), torch.tensor([[1.0]])).loglik
    nll.backward()
    assert torch.isfinite(log_a.grad) and abs(float(log_a.grad)) > 0
    _close(log_a.grad, want, rtol=1e-4)


def test_sample_draws_from_the_generator_with_the_shapes_of_jax():
    model = _pendulum_port()
    draws = [model.sample(torch.Generator().manual_seed(3), T=15, batch_shape=(2, 3))
             for _ in range(2)]
    x, y = draws[0]
    assert x.shape == (2, 3, 15, 2) and y.shape == (2, 3, 15, 1)
    assert torch.equal(x, draws[1][0]) and torch.equal(y, draws[1][1])
    # The observations are h of the states plus noise of variance R.
    resid = (y - torch.sin(x[..., :1])).flatten()
    assert abs(float(resid.var()) - 0.05) < 0.03
    sm = model.smooth(y, method="ekf").mean
    assert sm.shape == (2, 3, 15, 2) and torch.all(torch.isfinite(sm))


def test_nlssm_from_numpy_round_trips_the_jax_arrays():
    jax_model = _pendulum_jax()
    arrays = {k: np.asarray(v) for k, v in dataclasses.asdict(jax_model).items()
              if k not in ("f", "h")}
    port = convert.nlssm_from_numpy(arrays, f=_pendulum_port().f, h=_pendulum_port().h,
                                    device="cpu")
    for k, v in arrays.items():
        assert np.array_equal(getattr(port, k).numpy(), v)
    with pytest.raises(ValueError, match="Q, R, m0, P0"):
        convert.nlssm_from_numpy({**arrays, "f": None}, f=port.f, h=port.h, device="cpu")


@pytest.mark.parametrize("call, error", [
    (lambda m, y: m.filter(y, method="pf"), ValueError),
    (lambda m, y: m.smooth(y, method="ekf", alpha=0.5), TypeError),
])
def test_bad_methods_and_options_raise_as_jax(call, error):
    with pytest.raises(error):
        call(_linear(), torch.zeros(5, 1))
