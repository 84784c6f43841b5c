"""Port parity: the switching and particle state-space models
(``cortex_tpu_torch.models.SLDS``, ``particle_filter``,
``systematic_resample``, ``rbpf_filter``) against the JAX package.

The same numpy inputs go through both packages on the CPU.  JAX's random
draws cannot be made in torch, so the parity tests feed JAX-sampled series,
and where a filter draws, they compare what does not depend on the draws.
Bars:

- SLDS against JAX: atol 1e-6 / rtol 1e-5 (tests/test_slds.py's batched bar);
  K = 1 against the exact Kalman filter: rtol 1e-4, atol 1e-5
  (tests/test_slds.py's);
- systematic resampling: the same indices as JAX for the same offset ``u``;
  the weight proportions within 0.02 over 200 draws (tests/test_particle.py);
- the particle filter without resampling and with a deterministic transition
  against JAX: rtol 1e-5; with noise against the Kalman filter: the bars of
  tests/test_particle.py (mean error 0.05, log evidence 1.5, ESS 5%);
- the RBPF with K = 1 against the exact Kalman evidence at rtol 1e-4 and JAX's
  RBPF at rtol 1e-5; with K = 2 against the IMM: the bars of
  tests/test_rbpf.py (evidence 8, regime posteriors 0.1);
- batched replicas against single-sequence calls: equal (K = 1, or no
  resampling: nothing random is drawn).
"""

import dataclasses
import importlib.util
import inspect
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cortex_tpu_torch import convert, models
from cortex_tpu_torch.models import SLDS, particle_filter, rbpf_filter, systematic_resample
from cortex_tpu_torch.models.particle import systematic_indices

import cortex_tpu.models as jmodels
from cortex_tpu.models.particle import particle_filter as j_particle_filter
from cortex_tpu.models.particle import systematic_resample as j_systematic_resample


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

TWO = dict(Pi=[[0.97, 0.03], [0.03, 0.97]], A=[0.98, 0.98], Q=[0.02, 2.0], H=[1.0, 1.0],
           R=[0.1, 0.1], prior=(0.0, 1.0))
ONE = dict(Pi=[[1.0]], A=[0.9], Q=[0.4], H=[1.0], R=[0.6], prior=(0.0, 2.0))
SAME = dict(Pi=[[0.5, 0.5], [0.5, 0.5]], A=[0.8, 0.8], Q=[0.3, 0.3], H=[1.0, 1.0],
            R=[0.5, 0.5])


def _jax_slds(params):
    return jmodels.SLDS(**{k: jnp.asarray(v, jnp.float32) if k != "prior" else v
                           for k, v in params.items()})


def _pair(params):
    """The JAX SLDS and the port's, carried across by ``slds_from_numpy``."""
    jax_model = _jax_slds(params)
    fields = {k: v if k == "prior" or v is None else np.asarray(v)
              for k, v in dataclasses.asdict(jax_model).items()}
    return jax_model, convert.slds_from_numpy(fields, device="cpu")


def _walk(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).cumsum(axis=-1).astype(np.float32)


def _close(port, ref, rtol, atol=0.0):
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    np.testing.assert_allclose(port.numpy(), ref, rtol=rtol, atol=atol)


# -- SLDS ---------------------------------------------------------------------------------


def test_slds_from_numpy_takes_the_jax_dataclass():
    jax_model, port = _pair(TWO)
    assert port.K == 2 and port.prior == (0.0, 1.0)
    assert port.Pi.dtype == torch.float32 and port.w0.shape == (2,)
    _close(port.w0, [0.5, 0.5], 0.0)
    with pytest.raises(ValueError, match="not SLDS parameters"):
        convert.slds_from_numpy({**TWO, "B": 1.0}, device="cpu")
    assert inspect.signature(convert.slds_from_numpy).parameters["device"].default == "cuda"


def test_slds_k1_reduces_to_exact_kalman():
    y = _walk(0, 60)
    jax_model, port = _pair(ONE)
    got = port.filter(torch.from_numpy(y))
    kalman = models.LGSSM(A=0.9, Q=0.4, H=1.0, R=0.6)
    exact = kalman.filter(torch.from_numpy(y), prior=(0.0, 2.0))
    _close(got.mean, exact.mean.numpy(), 1e-4, 1e-5)
    _close(got.variance, exact.variance.numpy(), 1e-4, 1e-5)
    _close(got.loglik, jmodels.LGSSM(A=0.9, Q=0.4, H=1.0, R=0.6).log_evidence(
        jnp.asarray(y), prior=(0.0, 2.0)), 1e-4)
    _close(got.regime_probs[..., 0], np.ones(60), 0.0)


@pytest.mark.parametrize("params", [TWO, SAME, ONE], ids=["two-regime", "identical", "K=1"])
def test_slds_filter_matches_jax(params):
    jax_model, port = _pair(params)
    _, _, y = jax.jit(lambda k: jax_model.sample(k, T=50, batch_shape=(3, 4)))(
        jax.random.PRNGKey(1))
    want = jax.jit(jax_model.filter)(y)
    got = port.filter(torch.from_numpy(np.asarray(y)))
    for field in want._fields:
        _close(getattr(got, field), getattr(want, field), 1e-5, 1e-6)


def test_identical_regimes_match_k1():
    y = torch.from_numpy(_walk(1, 60))
    # Lists follow Pi, a CPU tensor: arrays alone would go to the card.
    single = SLDS(torch.tensor([[1.0]]), [0.8], [0.3], [1.0], [0.5])
    double = SLDS(**dict(SAME, Pi=torch.tensor(SAME["Pi"])))
    a, b = single.filter(y), double.filter(y)
    for field in ("mean", "variance", "loglik"):
        _close(getattr(b, field), getattr(a, field).numpy(), 1e-4, 1e-5)


def test_slds_batched_matches_single():
    _, port = _pair(TWO)
    gen = torch.Generator().manual_seed(1)
    _, _, y = port.sample(gen, 50, (3, 4))
    beliefs = port(y)
    assert beliefs.mean.shape == (3, 4, 50)
    assert beliefs.regime_probs.shape == (3, 4, 50, 2)
    assert beliefs.loglik.shape == (3, 4)
    one = port.filter(y[2, 1])
    _close(beliefs.mean[2, 1], one.mean.numpy(), 1e-5, 1e-6)
    _close(beliefs.loglik[2, 1], one.loglik.numpy(), 1e-5)
    _close(beliefs.regime_probs.sum(-1), np.ones((3, 4, 50)), 1e-5)
    _close(port.log_evidence(y), beliefs.loglik.numpy(), 0.0)


def test_slds_samples_follow_the_model_and_are_classified():
    """Regimes switch at Pi's rate, the series has the regimes' spread, and
    the IMM picks the true regime of 80% of the steps (tests/test_slds.py)."""
    _, port = _pair(TWO)
    gen = torch.Generator().manual_seed(0)
    s, x, y = port.sample(gen, 400, (8,))
    assert s.shape == x.shape == y.shape == (8, 400)
    assert s.dtype == torch.int32 and set(s.unique().tolist()) <= {0, 1}
    switches = float((s[:, 1:] != s[:, :-1]).float().mean())
    assert 0.015 < switches < 0.05
    step = (x[:, 1:] - 0.98 * x[:, :-1]).pow(2)
    calm = float(step[s[:, 1:] == 0].mean())
    volatile = float(step[s[:, 1:] == 1].mean())
    assert 0.01 < calm < 0.03 and 1.6 < volatile < 2.4
    beliefs = port.filter(y)
    assert float((beliefs.regime_probs.argmax(-1) == s).float().mean()) > 0.8
    single = models.LGSSM(A=0.98, Q=0.02, H=1.0, R=0.1)
    assert float(beliefs.loglik.mean()) > float(single.log_evidence(y, prior=(0.0, 1.0)).mean())


# -- systematic resampling -----------------------------------------------------------------


@pytest.mark.parametrize("n, scale, seed", [(4, 1.0, 0), (17, 3.0, 1), (200, 0.5, 2),
                                             (1000, 5.0, 3), (64, 20.0, 4)])
def test_systematic_indices_match_jax(n, scale, seed):
    log_w = (scale * np.random.default_rng(seed).normal(size=n)).astype(np.float32)
    resample = jax.jit(j_systematic_resample)
    for i in range(8):
        key = jax.random.PRNGKey(100 * seed + i)
        want = np.asarray(resample(key, jnp.asarray(log_w)))
        u = torch.tensor(np.asarray(jax.random.uniform(key)))
        got = systematic_indices(torch.from_numpy(log_w), u)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_a_start_at_n_is_dropped_as_jax_drops_it():
    """Particle 3 has no weight, so its children would start at slot N = 4:
    JAX drops that start, the port cuts its spare slot off."""
    log_w = np.log(np.asarray([1.0, 1.0, 1.0, 1e-30], np.float32))
    for u in (0.05, 0.1, 0.5, 0.95):
        want = np.asarray(j_systematic_resample_at(log_w, u))
        got = systematic_indices(torch.from_numpy(log_w), torch.tensor(u, dtype=torch.float32))
        np.testing.assert_array_equal(got.numpy(), want)
        assert 3 not in got.tolist()


def j_systematic_resample_at(log_w, u):
    """JAX's systematic resampling with its offset fixed at ``u``: the
    function's own body after the draw (cortex_tpu/models/particle.py:46-54)."""
    n = log_w.shape[0]
    w = jax.nn.softmax(jnp.asarray(log_w))
    C = jnp.clip(jnp.ceil(jnp.cumsum(w) * n - jnp.float32(u)), 0, n).astype(jnp.int32)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), C[:-1]])
    owners = jnp.zeros((n,), jnp.int32).at[starts].max(jnp.arange(n, dtype=jnp.int32),
                                                       mode="drop")
    return jax.lax.cummax(owners)


def test_systematic_indices_batch_over_replicas():
    rng = np.random.default_rng(5)
    log_w = torch.from_numpy((2.0 * rng.normal(size=(3, 2, 50))).astype(np.float32))
    u = torch.from_numpy(rng.random((3, 2)).astype(np.float32))
    got = systematic_indices(log_w, u)
    for i in range(3):
        for j in range(2):
            assert torch.equal(got[i, j], systematic_indices(log_w[i, j], u[i, j]))


def test_systematic_resample_preserves_weight_proportions():
    gen = torch.Generator().manual_seed(0)
    log_w = torch.log(torch.tensor([0.5, 0.3, 0.15, 0.05]))
    counts = np.zeros(4)
    for _ in range(200):
        counts += np.bincount(systematic_resample(gen, log_w).numpy(), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.5, 0.3, 0.15, 0.05], atol=0.02)


# -- the particle filter -------------------------------------------------------------------


def _log_lik(y_t, x):
    return -0.5 * ((y_t - x) ** 2 / 0.5 + math.log(2 * math.pi * 0.5))


def test_particle_filter_matches_jax_without_resampling():
    """A deterministic transition and no resampling: nothing is drawn, so both
    packages compute the same weights, moments and evidence."""
    rng = np.random.default_rng(0)
    y = _walk(1, 30)
    init = (3.0 * rng.normal(size=(500,))).astype(np.float32)
    want = j_particle_filter(jax.random.PRNGKey(0), jnp.asarray(y), lambda k, x: 0.9 * x + 0.1,
                             _log_lik, jnp.asarray(init), ess_threshold=0.0)
    got = particle_filter(torch.Generator(), torch.from_numpy(y), lambda g, x: 0.9 * x + 0.1,
                          _log_lik, torch.from_numpy(init), ess_threshold=0.0)
    for field in want._fields:
        _close(getattr(got, field), getattr(want, field), 1e-5, 1e-6)


def test_particle_filter_matches_kalman_on_linear_model():
    model = jmodels.LGSSM(A=0.9, Q=0.3, H=1.0, R=0.5)
    _, y = model.sample(jax.random.PRNGKey(0), T=60)
    n = 20_000
    gen = torch.Generator().manual_seed(1)
    init = math.sqrt(10.0) * torch.randn(n, generator=gen)

    def transition(g, x):
        return 0.9 * x + math.sqrt(0.3) * torch.randn(x.shape, generator=g)

    result = particle_filter(gen, torch.from_numpy(np.asarray(y)), transition, _log_lik, init)
    exact = model.filter(y, prior=(0.0, 10.0))
    assert np.abs(result.means.numpy() - np.asarray(exact.mean)).mean() < 0.05
    exact_logZ = float(model.log_evidence(y, prior=(0.0, 10.0)))
    assert float(result.log_evidence) == pytest.approx(exact_logZ, abs=1.5)
    assert float(result.ess.min()) > 0.05 * n
    assert result.particles.shape == (n,) and result.ess.shape == (60,)


def test_particle_filter_batched_replicas_equal_single_calls():
    rng = np.random.default_rng(2)
    y = _walk(3, (3, 25))
    init = (3.0 * rng.normal(size=(3, 400))).astype(np.float32)

    def run(y_, init_, batch_ndim):
        return particle_filter(torch.Generator(), torch.from_numpy(y_),
                               lambda g, x: 0.9 * x, _log_lik, torch.from_numpy(init_),
                               ess_threshold=0.0, batch_ndim=batch_ndim)

    batched = run(y, init, 1)
    assert batched.means.shape == (3, 25) and batched.log_evidence.shape == (3,)
    assert batched.particles.shape == (3, 400)
    for r in range(3):
        single = run(y[r], init[r], 0)
        for field in single._fields:
            _close(getattr(batched, field)[r], getattr(single, field).numpy(), 1e-6, 1e-6)


def test_particle_filter_resamples_each_replica_on_its_own():
    """With a vector state and noise: shapes, finite moments, and an ESS trace
    that resampling keeps up in every replica."""
    gen = torch.Generator().manual_seed(4)
    y = torch.from_numpy(_walk(4, (2, 3, 20, 2)))
    init = torch.randn((2, 3, 300, 2), generator=gen)

    def transition(g, x):
        return 0.9 * x + 0.5 * torch.randn(x.shape, generator=g)

    def log_lik(y_t, x):
        return -0.5 * ((y_t - x) ** 2).sum(-1) / 0.5

    res = particle_filter(gen, y, transition, log_lik, init, batch_ndim=2)
    assert res.means.shape == res.variances.shape == (2, 3, 20, 2)
    assert res.ess.shape == (2, 3, 20) and res.particles.shape == (2, 3, 300, 2)
    assert bool(torch.isfinite(res.means).all()) and bool(torch.isfinite(res.log_evidence).all())
    assert float(res.ess.mean()) > 30.0


# -- the Rao-Blackwellized particle filter -------------------------------------------------


def test_rbpf_k1_log_evidence_is_exact_and_matches_jax():
    y = _walk(0, 80)
    jax_model, port = _pair(ONE)
    res = rbpf_filter(torch.Generator().manual_seed(0), port, torch.from_numpy(y),
                      n_particles=16)
    exact = models.LGSSM(A=0.9, Q=0.4, H=1.0, R=0.6).log_evidence(
        torch.from_numpy(y), prior=(0.0, 2.0))
    _close(res.log_evidence, exact.numpy(), 1e-4)
    _close(res.ess, np.full(80, 16.0), 1e-4)
    kalman = jmodels.LGSSM(A=0.9, Q=0.4, H=1.0, R=0.6).filter(
        jnp.asarray(y), prior=(jnp.asarray(0.0), jnp.asarray(2.0)))
    _close(res.mean, kalman.mean, 1e-4, 1e-5)
    want = jax.jit(lambda k, y_: jmodels.rbpf_filter(k, jax_model, y_, n_particles=16))(
        jax.random.PRNGKey(0), jnp.asarray(y))
    for field in want._fields:
        _close(getattr(res, field), getattr(want, field), 1e-5, 1e-6)


def test_rbpf_batched_replicas_equal_single_calls():
    """K = 1 draws nothing that matters, so each replica of a batched call
    equals the single-sequence call."""
    y = torch.from_numpy(_walk(6, (2, 3, 40)))
    _, port = _pair(ONE)
    batched = rbpf_filter(torch.Generator().manual_seed(1), port, y, n_particles=32)
    assert batched.regime_probs.shape == (2, 3, 40, 1)
    assert batched.mean.shape == batched.ess.shape == (2, 3, 40)
    assert batched.log_evidence.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            single = rbpf_filter(torch.Generator().manual_seed(2), port, y[i, j], n_particles=32)
            for field in single._fields:
                _close(getattr(batched, field)[i, j], getattr(single, field).numpy(), 1e-6, 1e-6)


def test_rbpf_two_regimes_track_the_truth_and_agree_with_imm():
    """tests/test_rbpf.py's bars, on a single series and on four replicas of
    a batched call, each against the IMM."""
    _, port = _pair(TWO)
    gen = torch.Generator().manual_seed(3)
    s, _, y = port.sample(gen, 300, (4,))
    batched = rbpf_filter(gen, port, y, n_particles=1024)
    single = rbpf_filter(gen, port, y[0], n_particles=1024)
    imm = port.filter(y)
    _close(batched.regime_probs.sum(-1), np.ones((4, 300)), 1e-4)
    for res, r in [(single, 0)] + [(batched, r) for r in range(4)]:
        probs = res.regime_probs if res is single else res.regime_probs[r]
        evidence = res.log_evidence if res is single else res.log_evidence[r]
        assert float((probs.argmax(-1) == s[r]).float().mean()) > 0.8
        assert abs(float(evidence) - float(imm.loglik[r])) < 8.0
        assert float((probs[:, 1] - imm.regime_probs[r, :, 1]).abs().mean()) < 0.1


# -- chip_smoke's state-space phase --------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_ssm_main_path_rehearses_on_cpu():
    """chip_smoke's state-space phase at a small size on the CPU: the IMM
    against the float64 IMM, the RBPF and the particle filter within their
    bars."""
    checks = _chip_smoke().run_ssm_main_path(
        torch, models, "cpu", shapes={"slds": (64, 40), "rbpf": (16, 128, 40),
                                      "pf": (32, 1024, 40)}, n_ref=16)
    assert [c["path"] for c in checks] == ["SLDS.filter", "SLDS.filter", "rbpf_filter K=1",
                                           "rbpf_filter K=2", "particle_filter"]


def test_chip_smoke_numpy_imm_matches_jax_in_float64():
    """The float64 IMM chip_smoke holds the card to, against the JAX SLDS in
    float64 (rtol 1e-9)."""
    smoke = _chip_smoke()
    y = _walk(7, (3, 30)).astype(np.float64)
    with jax.enable_x64(True):
        for params in (TWO, ONE):
            model = jmodels.SLDS(**{k: jnp.asarray(v, jnp.float64) if k != "prior" else v
                                    for k, v in params.items()})
            want = jax.jit(model.filter)(jnp.asarray(y))
            got = smoke.numpy_imm(y, **params)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9, atol=1e-12)
