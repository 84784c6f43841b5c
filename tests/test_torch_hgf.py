"""Port parity: cortex_tpu_torch's HGF and BinaryHGF against cortex_tpu's.

``models.HGF`` (step, filter by scan and by the kernel's plain version,
track subsets, log-likelihood and its gradient), ``models.BinaryHGF``, the
converters, the slice end to end and chip_smoke's HGF path rehearsed, all on
the CPU.  The same numpy inputs, made from a seed, go through both packages
in float32, at tests/test_hgf.py's bar: rtol 1e-5 (with atol 1e-5 where a
value can be near 0).
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
from cortex_tpu_torch import convert, models, ops, parallel
from cortex_tpu_torch.models import HGF, BinaryHGF, BinaryHGFState, HGFState
from cortex_tpu_torch.ops import kernels

from cortex_tpu import models as jmodels


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
NONDEFAULT = dict(kappa=1.4, omega=-3.0, theta=0.2, pi_u=4.0, max_log_nu=8.0, min_pi2=0.05,
                  max_mu2_step=2.0)
GUARDS = dict(kappa=2.0, omega=-1.0, theta=0.5, pi_u=1000.0, max_log_nu=1.5, min_pi2=0.3,
              max_mu2_step=0.1)
PARAMS = [{}, NONDEFAULT, GUARDS]
PARAM_IDS = ["default", "nondefault", "guards"]
SHAPE = (24, 40)  # one shape for every JAX call: JAX compiles each function once per shape


def _series(seed, params, shape=SHAPE):
    """A random walk, or for the guard parameters 10 x normal noise, which
    makes every guard fire."""
    rng = np.random.default_rng(seed)
    if params is GUARDS:
        return (10.0 * rng.normal(size=shape)).astype(np.float32)
    return (0.2 * rng.normal(size=shape).cumsum(-1)).astype(np.float32)


def _state(seed, n=SHAPE[0]):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32), (1 + 3 * rng.random(n)).astype(np.float32),
            rng.normal(size=n).astype(np.float32), (0.5 + rng.random(n)).astype(np.float32))


def _close(port, ref, tol=1e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


def _torch(arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("params", PARAMS, ids=PARAM_IDS)
def test_step_matches_jax(params):
    state = _state(1)
    u = _series(2, params)[:, 0]
    got, delta1 = HGF(**params).step(HGFState(*_torch(state)), torch.from_numpy(u))
    want, want_delta1 = jmodels.HGF(**params).step(
        jmodels.HGFState(*map(jnp.asarray, state)), jnp.asarray(u))
    for g, w in zip(got, want):
        _close(g, w)
    _close(delta1, want_delta1)


@pytest.mark.parametrize("given_state", [False, True], ids=["zero-state", "given-state"])
@pytest.mark.parametrize("params", PARAMS, ids=PARAM_IDS)
def test_filter_scan_matches_jax(params, given_state):
    u = _series(3, params)
    state = _state(4) if given_state else None
    got_final, got_traj = HGF(**params).filter(
        torch.from_numpy(u), state=HGFState(*_torch(state)) if state else None)
    want_final, want_traj = jmodels.HGF(**params).filter(
        jnp.asarray(u), state=jmodels.HGFState(*map(jnp.asarray, state)) if state else None)
    for g, w in zip(tuple(got_final) + tuple(got_traj), tuple(want_final) + tuple(want_traj)):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("method", ["scan", "fused"])
@pytest.mark.parametrize("tracks", [(), ("mu2", "delta1", "mu1"), ("pi2",)],
                         ids=["none", "reordered", "one"])
def test_track_subsets_match_jax(method, tracks):
    """Requested tracks in the caller's order, None in the other slots; the
    fused path's plain version against the Pallas kernel in interpret mode."""
    u = _series(5, {})
    final, traj = HGF().filter(torch.from_numpy(u), method=method, tracks=tracks)
    jax_method = "pallas" if method == "fused" else "scan"
    want_final, want_traj = jmodels.HGF().filter(jnp.asarray(u), method=jax_method, tracks=tracks)
    for g, w in zip(final, want_final):
        _close(g, w)
    for name, g, w in zip(traj._fields, traj, want_traj):
        assert (g is None) == (w is None), name
        if g is not None:
            _close(g, w)


def test_fused_and_scan_agree_with_nondefault_parameters():
    u = torch.from_numpy(_series(6, NONDEFAULT))
    model = HGF(**NONDEFAULT)
    scan = model.filter(u)
    fused = model.filter(u, method="fused")
    for g, w in zip(tuple(fused[0]) + tuple(fused[1]), tuple(scan[0]) + tuple(scan[1])):
        assert torch.equal(g, w)  # one step function, the same float32 operations


@pytest.mark.parametrize("given_state", [False, True], ids=["zero-state", "given-state"])
@pytest.mark.parametrize("params", [{}, NONDEFAULT], ids=PARAM_IDS[:2])
def test_log_likelihood_matches_jax(params, given_state):
    u = _series(7, params)
    state = _state(8) if given_state else None
    got = HGF(**params).log_likelihood(
        torch.from_numpy(u), HGFState(*_torch(state)) if state else None)
    want = jmodels.HGF(**params).log_likelihood(
        jnp.asarray(u), jmodels.HGFState(*map(jnp.asarray, state)) if state else None)
    assert got.shape == SHAPE[:1]
    _close(got, want)


def test_log_likelihood_gradient_matches_jax():
    """Autograd through the scan with tensor parameters against jax.grad:
    rtol 1e-4 (two float32 backward passes, summed in other orders)."""
    u = _series(9, {})
    omega = torch.tensor(-2.5, requires_grad=True)
    log_theta = torch.tensor(-2.0, requires_grad=True)
    model = HGF(omega=omega, theta=torch.exp(log_theta))
    torch.mean(model.log_likelihood(torch.from_numpy(u))).backward()

    def ll(om, lt):
        return jnp.mean(jmodels.HGF(omega=om, theta=jnp.exp(lt)).log_likelihood(jnp.asarray(u)))

    g_om, g_lt = jax.grad(ll, argnums=(0, 1))(jnp.float32(-2.5), jnp.float32(-2.0))
    np.testing.assert_allclose(omega.grad.item(), float(g_om), rtol=1e-4)
    np.testing.assert_allclose(log_theta.grad.item(), float(g_lt), rtol=1e-4)


def test_parameters_may_be_module_parameters():
    model = HGF(omega=torch.nn.Parameter(torch.tensor(-2.0)))
    assert [name for name, _ in model.named_parameters()] == ["omega"]
    assert isinstance(model.kappa, float) and model.params()["omega"] is model.omega
    assert "omega=" in repr(model)


@pytest.mark.parametrize(
    "u, kwargs, match",
    [
        (torch.zeros(2, 3, 4), {}, "requires u of shape"),
        (torch.zeros(3, 4), {"state": HGF().init_state((2,), device="cpu")}, "initial state"),
        (torch.zeros(3, 4), {"tracks": ("mu1", "bogus")}, "unknown tracks"),
    ],
)
def test_fused_keeps_the_jax_limits(u, kwargs, match):
    with pytest.raises(ValueError, match=match):
        HGF().filter(u, method="fused", **kwargs)


def test_fused_refuses_a_parameter_that_needs_its_gradient():
    model = HGF(omega=torch.tensor(-2.0, requires_grad=True))
    u = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="method='scan'"):
        model.filter(u, method="fused")
    model.filter(u)  # the scan takes it


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="Unknown method"):
        HGF().filter(torch.zeros(3, 4), method="pallas")


@pytest.mark.parametrize("params", [{}, dict(kappa=1.5, omega=-3.0, theta=0.2, max_log_nu=2.0,
                                             min_pi3=0.3, max_mu3_step=0.2)],
                         ids=["default", "nondefault"])
def test_binary_step_and_filter_match_jax(params):
    rng = np.random.default_rng(10)
    u = (rng.random(SHAPE) < 0.7).astype(np.float32)
    state = _state(11)
    model, jax_model = BinaryHGF(**params), jmodels.BinaryHGF(**params)
    got, p_hat = model.step(BinaryHGFState(*_torch(state)), torch.from_numpy(u[:, 0]))
    want, want_p = jax_model.step(jmodels.BinaryHGFState(*map(jnp.asarray, state)),
                                  jnp.asarray(u[:, 0]))
    for g, w in zip(tuple(got) + (p_hat,), tuple(want) + (want_p,)):
        _close(g, w)
    for init in (None, state):
        got = model.filter(torch.from_numpy(u),
                           BinaryHGFState(*_torch(init)) if init else None)
        want = jax_model.filter(jnp.asarray(u),
                                jmodels.BinaryHGFState(*map(jnp.asarray, init)) if init else None)
        for g, w in zip(tuple(got[0]) + tuple(got[1]), tuple(want[0]) + tuple(want[1])):
            assert g.shape == w.shape
            _close(g, w)


def test_converters_take_the_jax_models_and_states():
    jax_hgf = jmodels.HGF(**NONDEFAULT)
    port = convert.hgf_from_numpy(dataclasses.asdict(jax_hgf))
    assert port.params() == {k: float(v) for k, v in dataclasses.asdict(jax_hgf).items()}
    binary = convert.binary_hgf_from_numpy(dataclasses.asdict(jmodels.BinaryHGF(min_pi3=0.2)))
    assert binary.min_pi3 == 0.2 and binary.omega == -2.0
    with pytest.raises(ValueError, match="not HGF parameters"):
        convert.hgf_from_numpy({"kappa": 1.0, "min_pi3": 0.1})
    with pytest.raises(ValueError, match="not BinaryHGF parameters"):
        convert.binary_hgf_from_numpy({"pi_u": 1.0})
    state = jax_hgf.init_state((3,))
    got = convert.hgf_state_from_numpy(state, device="cpu")
    assert isinstance(got, HGFState) and got.pi1.dtype == torch.float32
    assert torch.equal(got.pi1, torch.ones(3))
    got = convert.binary_hgf_state_from_numpy(_state(12, n=2), device="cpu")
    assert isinstance(got, BinaryHGFState) and got.mu3.shape == (2,)


@pytest.mark.parametrize(
    "fn",
    [HGF().init_state, BinaryHGF().init_state, convert.hgf_state_from_numpy,
     convert.binary_hgf_state_from_numpy, parallel.stream_filter, parallel.StreamingSession],
    ids=lambda fn: getattr(fn, "__qualname__", str(fn)),
)
def test_entry_points_that_make_tensors_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_slice_end_to_end():
    """A JAX model and state carried across, filtered in chunks by both
    packages' streaming, against both packages' batch filters and the
    port's fused path."""
    jax_model = jmodels.HGF(**NONDEFAULT)
    port = convert.hgf_from_numpy(dataclasses.asdict(jax_model))
    u = _series(13, NONDEFAULT)
    state = port.init_state((SHAPE[0],), device="cpu")
    chunks = [u[:, i:i + 10] for i in range(0, SHAPE[1], 10)]
    final, outs = parallel.stream_filter(lambda st, c: port.filter(c, state=st), chunks, state,
                                         device="cpu")
    want, _ = jax_model.filter(jnp.asarray(u))
    fused, _ = port.filter(torch.from_numpy(u), method="fused", tracks=())
    assert len(outs) == 4
    for g, f, w in zip(final, fused, want):
        _close(g, w)
        assert torch.equal(g, f)
    ll = port.log_likelihood(torch.from_numpy(u))
    _close(ll, jax_model.log_likelihood(jnp.asarray(u)))


def test_chip_smoke_hgf_main_path_rehearses_on_cpu():
    """chip_smoke's HGF phase, driven on the CPU at a small size: the same
    entry points and checks as on the card, with the plain versions."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    before = dict(kernels.LAUNCHES)
    checks = smoke.run_hgf_main_path(torch, models, ops, parallel, "cpu", R=96, T=64, chunk=16)
    assert kernels.LAUNCHES == before  # the CPU takes the plain version
    assert {c["path"] for c in checks} == {
        "HGF.filter scan", "HGF.filter fused", "hgf_filter_fused", "stream_filter",
        "StreamingSession", "stream_filter fused", "StreamingSession fused", "BinaryHGF.filter"}
    # Each fused stream is held to the plain version chunk by chunk and to the
    # float64 HGF over the joined tracks.
    fused = [c for c in checks if c["path"].endswith(" fused") and "chunks" in c]
    assert sorted(c["against"] for c in fused) == sorted(2 * [
        "float64 numpy HGF", "plain version, carried states"])
    assert all(c["chunks"] == 4 for c in fused)
    # The float64 reference against the JAX model in float32.
    u = _series(14, GUARDS, shape=(6, 30))
    finals, tracks, fires = smoke.numpy_hgf(u, **GUARDS)
    want_final, want_traj = jmodels.HGF(**GUARDS).filter(jnp.asarray(u))
    assert all(fires.values())
    for got, want in zip(finals, want_final):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tracks["delta1"], np.asarray(want_traj.prediction_error),
                               rtol=1e-4, atol=1e-4)


# -- zero-length series: JAX's scan returns empty results ----------------------


def _shape_and_dtype(port, ref):
    assert tuple(port.shape) == np.asarray(ref).shape
    assert port.numpy().dtype == np.asarray(ref).dtype


@pytest.mark.parametrize("tracks", [None, ("mu1",), ("pi2", "delta1"), ()])
def test_filter_at_zero_steps_matches_jax(tracks):
    u = np.zeros((3, 0), np.float32)
    state, traj = HGF().filter(torch.from_numpy(u), method="scan", tracks=tracks)
    jstate, jtraj = jmodels.HGF().filter(jnp.asarray(u), method="scan", tracks=tracks)
    for got, want in zip(state, jstate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(traj, jtraj):
        assert (got is None) == (want is None)
        if got is not None:
            _shape_and_dtype(got, want)


def test_log_likelihood_at_zero_steps_matches_jax():
    u = np.zeros((3, 0), np.float32)
    got = HGF().log_likelihood(torch.from_numpy(u))
    want = jmodels.HGF().log_likelihood(jnp.asarray(u))
    _shape_and_dtype(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_binary_filter_at_zero_steps_matches_jax():
    u = np.zeros((3, 0), np.float32)
    state, traj = BinaryHGF().filter(torch.from_numpy(u))
    jstate, jtraj = jmodels.BinaryHGF().filter(jnp.asarray(u))
    for got, want in zip(state, jstate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(traj) == len(jtraj) == 5
    for got, want in zip(traj, jtraj):
        _shape_and_dtype(got, want)
