"""Port parity: cortex_tpu_torch's HMM path against cortex_tpu's.

``ops.hmm_forward_backward``/``hmm_viterbi``, ``models.HMM`` (smooth,
viterbi, Dirichlet VMP), the converters, the slice end to end and
chip_smoke's HMM main path, all on the CPU.  The same numpy inputs, made
from a seed, go through both packages in float32.  Bars: 1e-5 where both run
the same recursion (the log-space scan; the fused path's plain version
against the Pallas kernel in interpret mode); VMP by the scan against the
scan at rtol 1e-4, and by the kernel against the Pallas kernel at rtol 1e-3
(tests/test_hmm.py's bar for the kernel against the scan).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cortex_tpu_torch import convert, ops
from cortex_tpu_torch.models import HMM, HMMVMPState
from cortex_tpu_torch.ops import kernels

from cortex_tpu import models as jmodels
from cortex_tpu.ops.hmm import hmm_forward_backward as jax_fb
from cortex_tpu.ops.hmm import hmm_viterbi as jax_viterbi


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
# The slice's shape: R replicas of T steps, K states, M symbols.
R_, T_, K_, M_ = 16, 24, 3, 4


def _rng(seed):
    return np.random.default_rng(seed)


def _stochastic(rng, rows, cols):
    P = rng.random((rows, cols)) + 0.2
    return (P / P.sum(-1, keepdims=True)).astype(np.float32)


def _log_uniform(K):
    return np.log(np.full(K, 1.0 / K, dtype=np.float32))


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _obs(seed, shape=(R_, T_), M=M_, gaps=0.0):
    """Symbols |random walk| mod M (as the JAX bench makes them), with a
    share ``gaps`` of the steps missing (-1)."""
    rng = _rng(seed)
    obs = np.abs(rng.normal(size=shape).cumsum(-1)).astype(np.int64) % M
    return np.where(rng.random(shape) < gaps, -1, obs)


def _models(K=K_):
    log_pi = _log_uniform(K)
    return HMM(K, torch.from_numpy(log_pi)), jmodels.HMM(K=K, log_pi=jnp.asarray(log_pi))


def test_forward_backward_matches_jax_with_two_batch_axes():
    rng = _rng(0)
    log_lik = rng.normal(size=(2, 3, 9, 4)).astype(np.float32)
    log_A = np.log(np.stack([[_stochastic(rng, 4, 4) for _ in range(3)] for _ in range(2)]))
    log_pi = np.log(np.stack([[_stochastic(rng, 1, 4)[0] for _ in range(3)] for _ in range(2)]))
    port = ops.hmm_forward_backward(*map(torch.from_numpy, (log_lik, log_A, log_pi)))
    ref = jax_fb(*map(jnp.asarray, (log_lik, log_A, log_pi)))
    assert port.log_gamma.shape == (2, 3, 9, 4) and port.log_xi_sum.shape == (2, 3, 4, 4)
    for p, r in zip(port, ref):
        _close(p, r, rtol=1e-5, atol=1e-5)


def test_forward_backward_matches_jax_with_shared_parameters_and_one_step():
    rng = _rng(1)
    log_A, log_pi = np.log(_stochastic(rng, 3, 3)), _log_uniform(3)
    for T in (1, 7):
        log_lik = rng.normal(size=(5, T, 3)).astype(np.float32)
        port = ops.hmm_forward_backward(*map(torch.from_numpy, (log_lik, log_A, log_pi)))
        ref = jax_fb(*map(jnp.asarray, (log_lik, log_A, log_pi)))
        for p, r in zip(port, ref):
            _close(p, r, rtol=1e-5, atol=1e-5)  # T=1: log_xi_sum is -inf in both


def test_viterbi_matches_jax():
    rng = _rng(2)
    log_lik = rng.normal(size=(6, 15, 4)).astype(np.float32)
    log_A = np.log(_stochastic(rng, 4, 4))
    log_pi = np.log(_stochastic(rng, 1, 4)[0])
    port = ops.hmm_viterbi(*map(torch.from_numpy, (log_lik, log_A, log_pi)))
    ref = jax_viterbi(*map(jnp.asarray, (log_lik, log_A, log_pi)))
    assert port.shape == (6, 15)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    model, jmodel = _models(4)
    np.testing.assert_array_equal(
        model.viterbi(torch.from_numpy(log_lik[0]), torch.from_numpy(log_A)).numpy(),
        np.asarray(jmodel.viterbi(jnp.asarray(log_lik[0]), jnp.asarray(log_A))))


@pytest.mark.parametrize("underflow", [False, True])
def test_smooth_scan_and_fused_match_jax_scan_and_pallas(underflow):
    """The bars of tests/test_hmm.py:239-256 (marginals atol 1e-4,
    log-evidence rtol 1e-4) and 1e-5 for like against like.  With
    ``underflow``, log-likelihoods of -120 (0 in float32 after exp): the
    fused path is held to the Pallas kernel's floors, not to the scan."""
    rng = _rng(11)
    log_lik = rng.normal(size=(6, 20, 3)).astype(np.float32)
    if underflow:
        log_lik[rng.random(log_lik.shape) < 0.2] = -120.0
        log_lik[2, 9] = -120.0
    log_A = np.log(_stochastic(rng, 3, 3))
    model, jmodel = _models(3)
    args = torch.from_numpy(log_lik), torch.from_numpy(log_A)
    jargs = jnp.asarray(log_lik), jnp.asarray(log_A)
    scan, jscan = model.smooth(*args), jmodel.smooth(*jargs)
    fused, pallas = model.smooth(*args, method="fused"), jmodel.smooth(*jargs, method="pallas")
    for p, r in zip(scan, jscan):
        _close(p, r, rtol=1e-5, atol=1e-5)
    _close(torch.exp(fused.log_gamma), np.exp(pallas.log_gamma), rtol=0, atol=1e-5)
    _close(torch.exp(fused.log_xi_sum), np.exp(pallas.log_xi_sum), rtol=0, atol=1e-5)
    _close(fused.log_evidence, pallas.log_evidence, rtol=1e-5)
    if not underflow:
        _close(torch.exp(fused.log_gamma), np.exp(jscan.log_gamma), rtol=0, atol=1e-4)
        _close(fused.log_evidence, jscan.log_evidence, rtol=1e-4)
    assert torch.equal(model(*args).log_gamma, scan.log_gamma)


def test_unknown_methods_and_fused_shapes_raise():
    model, _ = _models()
    log_lik, log_A = torch.zeros(2, 5, K_), torch.zeros(K_, K_)
    obs = torch.zeros(4, 10, dtype=torch.int64)
    with pytest.raises(ValueError, match="Unknown method"):
        model.smooth(log_lik, log_A, method="pallas")
    with pytest.raises(ValueError, match="Unknown method"):
        model.fit_vmp(obs, n_symbols=2, method="kernel")
    with pytest.raises(ValueError, match=r"\(R, T, K\)"):
        model.smooth(log_lik[0], log_A, method="fused")
    with pytest.raises(ValueError, match="pooled"):
        model.fit_vmp(obs, n_symbols=2, method="fused")
    with pytest.raises(ValueError, match="pooled"):
        model.fit_vmp(obs[None], n_symbols=2, method="fused", pooled=True)
    with pytest.raises(ValueError, match="n_iterations"):
        model.fit_vmp(obs, n_symbols=2, n_iterations=0)
    with pytest.raises(ValueError, match="log_pi"):
        HMM(3, torch.zeros(4))


def _assert_fit(port, ref, rtol):
    _close(port.state.trans_alpha, ref.state.trans_alpha, rtol=rtol)
    _close(port.state.emis_alpha, ref.state.emis_alpha, rtol=rtol)
    _close(port.elbo, ref.elbo, rtol=rtol)


@pytest.mark.parametrize("pooled", [True, False], ids=["pooled", "per_replica"])
def test_fit_vmp_with_gaps_matches_jax(pooled):
    """Missing steps (-1) in both; from the default start and from a
    carried-over ``init_state``."""
    obs = _obs(5, gaps=0.1)
    model, jmodel = _models()
    port = model.fit_vmp(torch.from_numpy(obs), M_, n_iterations=5, pooled=pooled)
    ref = jmodel.fit_vmp(jnp.asarray(obs), M_, n_iterations=5, pooled=pooled)
    _assert_fit(port, ref, rtol=1e-4)
    _close(port.posterior.log_gamma, ref.posterior.log_gamma, rtol=1e-4, atol=1e-4)
    assert port.state.trans_alpha.shape == ((K_, K_) if pooled else (R_, K_, K_))
    # A second round from the first's posterior, carried across as numpy.
    init = convert.hmm_state_from_numpy(
        np.asarray(ref.state.trans_alpha), np.asarray(ref.state.emis_alpha), device="cpu")
    port2 = model.fit_vmp(torch.from_numpy(obs), M_, n_iterations=2, pooled=pooled,
                          init_state=init)
    ref2 = jmodel.fit_vmp(jnp.asarray(obs), M_, n_iterations=2, pooled=pooled,
                          init_state=ref.state)
    _assert_fit(port2, ref2, rtol=1e-4)


def test_fit_vmp_fused_matches_jax_pallas_and_scan():
    obs = _obs(6, gaps=0.05)
    model, jmodel = _models()
    fused = model.fit_vmp(torch.from_numpy(obs), M_, n_iterations=5, pooled=True, method="fused")
    pallas = jmodel.fit_vmp(jnp.asarray(obs), M_, n_iterations=5, pooled=True, method="pallas")
    _assert_fit(fused, pallas, rtol=1e-3)
    scan = model.fit_vmp(torch.from_numpy(obs), M_, n_iterations=5, pooled=True)
    _assert_fit(fused, scan, rtol=1e-3)


def test_one_hot_of_missing_and_out_of_range_symbols_is_zero():
    """A -1 step adds no emission count; the port builds the one-hot by
    comparison, as ``jax.nn.one_hot`` gives zero rows."""
    obs = np.array([[0, 1, -1, 1, -1, 0]])
    model, jmodel = _models(2)
    port = model.fit_vmp(torch.from_numpy(obs), 2, n_iterations=3)
    ref = jmodel.fit_vmp(jnp.asarray(obs), 2, n_iterations=3)
    _assert_fit(port, ref, rtol=1e-5)
    # Four observed steps, each adding one unit of emission count.
    prior = 1.0 * 2 * 2
    np.testing.assert_allclose(port.state.emis_alpha.sum().item(), prior + 4, rtol=1e-5)


def test_hmm_from_numpy_takes_the_jax_dataclass():
    _, jmodel = _models(4)
    port = convert.hmm_from_numpy(dataclasses.asdict(jmodel), device="cpu")
    assert isinstance(port, HMM) and port.K == 4
    assert port.log_pi.dtype == torch.float32 and port.log_pi.device.type == "cpu"
    _close(port.log_pi, jmodel.log_pi, rtol=0)
    assert "log_pi" in dict(port.named_buffers())
    with pytest.raises(ValueError, match="not HMM parameters"):
        convert.hmm_from_numpy({"K": 2, "log_pi": np.zeros(2), "A": 1}, device="cpu")
    state = convert.hmm_state_from_numpy(np.ones((2, 2)), None, device="cpu")
    assert isinstance(state, HMMVMPState) and state.emis_alpha is None


def test_slice_end_to_end():
    """R=16, T=24, K=3, M=4, 5 iterations: the JAX model carried across,
    pooled VMP by both E-steps and per-replica VMP with gaps, then smoothing
    and Viterbi under the learned posterior, against the JAX package."""
    obs = _obs(21)
    gappy = _obs(22, gaps=0.1)
    jmodel = jmodels.HMM(K=K_, log_pi=jnp.log(jnp.asarray([0.5, 0.3, 0.2])))
    model = convert.hmm_from_numpy(dataclasses.asdict(jmodel), device="cpu")
    fits = {
        "scan": (model.fit_vmp(torch.from_numpy(obs), M_, 5, pooled=True),
                 jmodel.fit_vmp(jnp.asarray(obs), M_, 5, pooled=True), 1e-4),
        "fused": (model.fit_vmp(torch.from_numpy(obs), M_, 5, pooled=True, method="fused"),
                  jmodel.fit_vmp(jnp.asarray(obs), M_, 5, pooled=True, method="pallas"), 1e-3),
        "per_replica": (model.fit_vmp(torch.from_numpy(gappy), M_, 5),
                        jmodel.fit_vmp(jnp.asarray(gappy), M_, 5), 1e-4),
    }
    for port, ref, rtol in fits.values():
        _assert_fit(port, ref, rtol)
    port, ref, _ = fits["scan"]
    A_hat = port.state.trans_alpha / port.state.trans_alpha.sum(-1, keepdim=True)
    B_hat = port.state.emis_alpha / port.state.emis_alpha.sum(-1, keepdim=True)
    log_lik = torch.log(B_hat).T[torch.from_numpy(obs)].contiguous()  # (R, T, K)
    jlog_lik = jnp.asarray(log_lik.numpy())
    jlog_A = jnp.asarray(torch.log(A_hat).numpy())
    for method, jmethod in (("scan", "scan"), ("fused", "pallas")):
        got = model.smooth(log_lik, torch.log(A_hat), method=method)
        want = jmodel.smooth(jlog_lik, jlog_A, method=jmethod)
        _close(torch.exp(got.log_gamma), np.exp(want.log_gamma), rtol=0, atol=1e-5)
        _close(got.log_evidence, want.log_evidence, rtol=1e-5)
    np.testing.assert_array_equal(model.viterbi(log_lik, torch.log(A_hat)).numpy(),
                                  np.asarray(jmodel.viterbi(jlog_lik, jlog_A)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_hmm_main_path_rehearses_on_cpu():
    """chip_smoke's HMM main path, driven on the CPU at a small size: the
    same entry points and checks as on the card, with the plain versions;
    and its float64 forward-backward against the JAX package's."""
    smoke = _load_chip_smoke()
    before = dict(kernels.LAUNCHES)
    checks = smoke.run_hmm_main_path(torch, HMM, ops, "cpu", R=96, T=20)
    assert kernels.LAUNCHES == before
    assert {c["path"] for c in checks} == {
        "smooth scan", "smooth fused", "hmm_forward_backward_fused", "pooled VMP fused",
        "per-replica VMP with gaps"}
    rng = _rng(7)
    log_lik = rng.normal(size=(3, 12, 4))
    log_A, log_pi = np.log(_stochastic(rng, 4, 4)), _log_uniform(4)
    gamma, log_z = smoke.numpy_hmm_smoother(log_lik, log_A, log_pi)
    ref = jax_fb(*map(jnp.asarray, (log_lik.astype(np.float32), log_A, log_pi)))
    np.testing.assert_allclose(gamma, np.exp(np.asarray(ref.log_gamma)), atol=1e-5)
    np.testing.assert_allclose(log_z, np.asarray(ref.log_evidence), rtol=1e-5)
    bound = smoke.hmm_bound(4096, 64, 4, counts=True)
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(4 * (2 * 4096 * 64 * 4 + 4096 + 20 + 4096 * 16)
                                              / 3.35e12 * 1e3)
