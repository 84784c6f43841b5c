"""Port parity: ``cortex_tpu_torch.models.GMM``, ``GMMFull`` and
``ops.free_energy`` against the JAX package.

The same data and initial means, made from a seed with numpy, go through
both packages on the CPU.  Bars: posteriors, responsibilities and free-energy
traces (≤ 10 iterations) at rtol 1e-4 / atol 1e-5 in float32 (digamma,
log-gamma and softmax by two libraries, sums in other orders) and at rtol
1e-9 / atol 1e-9 in float64, with JAX's 64-bit types switched on for the
call; the Bethe free energy at rtol 1e-5 (float32) and 1e-10 (float64), and
against the float64 prediction-error oracle at rtol 1e-4 (the bar of
tests/test_free_energy.py).  The default initialization draws with torch's
generator, not JAX's, so it is held by what it must do: K distinct data
points, the same pick for the same seed.
"""

import dataclasses
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cortex_tpu_torch import convert, models, ops
from cortex_tpu_torch.models import GMM, GMMFull
from cortex_tpu_torch.ops.free_energy import bethe_free_energy_chain, elbo_conjugate

import cortex_tpu.models as jmodels
from cortex_tpu.ops import lgssm_messages_scan as j_messages
from cortex_tpu.ops import free_energy as jfe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them,
    8-20x slower on small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = Path(__file__).resolve().parents[1]
TOL = {np.float32: (1e-4, 1e-5), np.float64: (1e-9, 1e-9)}
PAIRS = {"GMM": (GMM, jmodels.GMM), "GMMFull": (GMMFull, jmodels.GMMFull)}
PRIORS = {
    "GMM": {"alpha0": 2.0, "m0": 0.5, "beta0": 0.5, "a0": 2.0, "b0": 0.5},
    "GMMFull": {"alpha0": 2.0, "beta0": 0.5, "nu0": 4.0, "m0": 0.5, "w0_scale": 0.7},
}


def _close(port, ref, dtype, tol=None):
    assert isinstance(port, torch.Tensor)
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    assert port.numpy().dtype == ref.dtype
    rtol, atol = tol or TOL[dtype]
    np.testing.assert_allclose(port.numpy(), ref, rtol=rtol, atol=atol)


def _clusters(seed, batch=(3,), n=30, d=2, K=3):
    """``normal + 3·randint(0, K)`` per point, as the JAX bench's
    ``ladder.gmm`` makes its data; float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=batch + (n, d)) + 3.0 * rng.integers(0, K, size=batch + (n, 1))
    return x.astype(np.float32)


def _fit_both(name, x, n_iterations, dtype, **params):
    port_cls, jax_cls = PAIRS[name]
    K = params.pop("K", 3)
    init = x[..., :K, :]
    with jax.enable_x64(dtype == np.float64):
        x = x.astype(dtype)
        got = port_cls(K=K, **params).fit(torch.from_numpy(x), n_iterations=n_iterations,
                                          init_means=torch.from_numpy(init.astype(dtype)))
        want = jax_cls(K=K, **params).fit(jnp.asarray(x), n_iterations=n_iterations,
                                          init_means=jnp.asarray(init.astype(dtype)))
        want = jax.tree_util.tree_map(np.asarray, want)
    return got, want


def _same_result(got, want, dtype):
    for field in want.posterior._fields:
        _close(getattr(got.posterior, field), getattr(want.posterior, field), dtype)
    _close(got.responsibilities, want.responsibilities, dtype)
    _close(got.free_energy, want.free_energy, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(PAIRS))
def test_fit_matches_jax(name, dtype):
    got, want = _fit_both(name, _clusters(0, d=3), 8, dtype)
    assert got.free_energy.shape == (3, 8)
    _same_result(got, want, dtype)
    props = ["weights", "means"] + (["precisions"] if name == "GMM" else
                                    ["expected_precisions", "expected_covariances"])
    with jax.enable_x64(dtype == np.float64):
        for prop in props:
            _close(getattr(got.posterior, prop), getattr(want.posterior, prop), dtype)


@pytest.mark.parametrize("name", list(PAIRS))
def test_fit_with_other_priors_and_no_replica_axis_matches_jax(name):
    got, want = _fit_both(name, _clusters(1, batch=(), n=32, K=4), 10, np.float32, K=4,
                          **PRIORS[name])
    assert got.posterior.m.shape == (4, 2) and got.free_energy.shape == (10,)
    _same_result(got, want, np.float32)


@pytest.mark.parametrize("name", list(PAIRS))
def test_zero_iterations_return_the_initial_posterior_as_jax_does(name):
    got, want = _fit_both(name, _clusters(3), 0, np.float32)
    assert got.free_energy.shape == (3, 0) and got.free_energy.dtype == torch.float32
    assert not got.responsibilities.any()
    _same_result(got, want, np.float32)


@pytest.mark.parametrize("name", list(PAIRS))
def test_free_energy_does_not_increase_and_responsibilities_normalize(name):
    """tests/test_gmm.py's bars: every step of the trace within 1e-2 of
    non-increasing, a lower final value, rows of r summing to 1."""
    x = torch.from_numpy(_clusters(4, n=32))
    res = PAIRS[name][0](K=3).fit(x, n_iterations=20, init_means=x[:, :3])
    fe = res.free_energy.numpy()
    assert np.isfinite(fe).all() and (np.diff(fe, axis=-1) <= 1e-2).all()
    assert (fe[:, -1] < fe[:, 0]).all()
    np.testing.assert_allclose(res.responsibilities.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", list(PAIRS))
def test_default_initialization_picks_distinct_points_reproducibly(name):
    x = torch.from_numpy(_clusters(5, n=24))
    picks = [models.gmm.initial_means(x, 4, key) for key in
             (None, None, torch.Generator().manual_seed(0), torch.Generator().manual_seed(9))]
    assert picks[0].shape == (3, 4, 2)
    torch.testing.assert_close(picks[0], picks[1], rtol=0, atol=0)
    torch.testing.assert_close(picks[0], picks[2], rtol=0, atol=0)  # None seeds 0
    for pick in picks:
        rows = pick[0].tolist()
        assert len({tuple(r) for r in rows}) == 4 and all(r in x[0].tolist() for r in rows)
    assert not torch.equal(picks[0], picks[3])
    model = PAIRS[name][0](K=4)
    res = model.fit(x, n_iterations=5, key=torch.Generator().manual_seed(9))
    given = model.fit(x, n_iterations=5, init_means=picks[3])
    torch.testing.assert_close(res.posterior.m, given.posterior.m)
    assert torch.isfinite(res.free_energy).all()


def test_convert_carries_jax_posteriors_across():
    rng = np.random.default_rng(6)
    shapes = {"GMMPosterior": [(3,), (3, 2), (3, 2), (3, 2), (3, 2)],
              "GMMFullPosterior": [(3,), (3, 2), (3,), (3, 2, 2), (3,)]}
    for carry, kind in ((convert.gmm_posterior_from_numpy, models.GMMPosterior),
                        (convert.gmm_full_posterior_from_numpy, models.GMMFullPosterior)):
        fields = [rng.uniform(1.0, 2.0, size=s).astype(np.float32)
                  for s in shapes[kind.__name__]]
        want = getattr(jmodels, kind.__name__)(*map(jnp.asarray, fields))
        got = carry(want, device="cpu")
        assert type(got) is kind
        for field, value in zip(got._fields, want):
            _close(getattr(got, field), value, np.float32, (0, 0))
        _close(got.weights, want.weights, np.float32)
        with pytest.raises(ValueError, match="5 fields"):
            carry(tuple(want)[:4], device="cpu")
        assert inspect.signature(carry).parameters["device"].default == "cuda"
    assert dataclasses.asdict(jmodels.GMM(K=3, a0=2.0)) == dataclasses.asdict(GMM(K=3, a0=2.0))


# -- free energy ---------------------------------------------------------------------


def test_elbo_conjugate_composition():
    out = elbo_conjugate(torch.tensor(10.0), torch.tensor(2.0), torch.tensor(3.0))
    assert float(out) == pytest.approx(5.0)
    assert float(out) == float(jfe.elbo_conjugate(jnp.asarray(10.0), jnp.asarray(2.0),
                                                  jnp.asarray(3.0)))


@pytest.mark.parametrize("A, Q, dtype, tol", [(1.0, 1.0, np.float32, 1e-5),
                                              (0.9, 0.4, np.float64, 1e-10)])
def test_bethe_free_energy_chain_matches_jax_and_the_oracle(A, Q, dtype, tol):
    rng = np.random.default_rng(0)
    y = rng.normal(size=(4, 16)).cumsum(axis=-1).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        xi, w = j_messages(jnp.asarray(y))["obs"]
        want = np.asarray(jax.jit(jfe.bethe_free_energy_chain, static_argnums=(2, 3))(
            xi, w, Q, A))
    port_xi, port_w = ops.lgssm_messages_scan(torch.from_numpy(y))["obs"]
    got = bethe_free_energy_chain(port_xi, port_w, Q=Q, A=A)
    _close(got, want, dtype, (tol, tol))
    # Oracle (tests/test_free_energy.py): the float64 filter over t >= 2 given
    # the filtered belief of y_1 alone.
    for b in range(4):
        m, v, ll = float(y[b, 0]), 1.0, 0.0
        for t in range(1, 16):
            pm, pv = A * m, A * A * v + Q
            s = pv + 1.0
            ll += -0.5 * (np.log(2 * np.pi * s) + (float(y[b, t]) - pm) ** 2 / s)
            m, v = pm + pv / s * (float(y[b, t]) - pm), pv - pv / s * pv
        assert float(got[b]) == pytest.approx(-ll, rel=1e-4)


def test_bethe_free_energy_decreases_with_better_fit():
    rng = np.random.default_rng(1)
    smooth = torch.from_numpy(0.01 * rng.normal(size=(1, 16)))
    rough = torch.from_numpy(5.0 * rng.normal(size=(1, 16)))
    fe_smooth = bethe_free_energy_chain(*ops.lgssm_messages_scan(smooth)["obs"], Q=1.0)
    fe_rough = bethe_free_energy_chain(*ops.lgssm_messages_scan(rough)["obs"], Q=1.0)
    assert float(fe_smooth[0]) < float(fe_rough[0])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_gmm_main_path_rehearses_on_cpu():
    """chip_smoke's GMM phase at a small size on the CPU: both fits against
    the float64 numpy VB-GMMs and the CPU, the free energies non-increasing,
    the Bethe free energy against its float64 sum."""
    checks = _chip_smoke().run_gmm_main_path(torch, models, ops, "cpu", R=8, N=32, n_ref=4,
                                             chain=(16, 20))
    assert [c["path"] for c in checks] == ["GMM.fit"] * 3 + ["GMMFull.fit"] * 3 + [
        "bethe_free_energy_chain"]


def test_chip_smoke_numpy_vb_gmms_match_jax_in_float64():
    """The float64 references chip_smoke holds the card to are themselves
    held to the JAX package's fits in float64 (rtol 1e-9)."""
    smoke = _chip_smoke()
    x = smoke.gmm_data(3, 24, 2, 3, seed=2).astype(np.float64)
    with jax.enable_x64(True):
        for reference, jax_cls in ((smoke.numpy_vb_gmm, jmodels.GMM),
                                   (smoke.numpy_vb_gmm_full, jmodels.GMMFull)):
            post, r, fe = reference(x, 3, x[:, :3], 5)
            want = jax_cls(K=3).fit(jnp.asarray(x), n_iterations=5,
                                    init_means=jnp.asarray(x[:, :3]))
            for got, ref in zip((*post, r, fe), (*want.posterior, want.responsibilities,
                                                 want.free_energy)):
                np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-9, atol=1e-9)
