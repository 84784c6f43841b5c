"""The port's entry points take what the JAX package's take, and return what
they return.

Each case feeds the same numpy inputs, float64 (int64 for symbols) and laid
out as reversed views (negative strides), to a JAX entry point and to its
counterpart in the port, and compares the results' dtypes, shapes and values.
JAX makes such inputs float32 (int32) arrays; the port makes them float32
(int32) tensors on the device of the tensors among the inputs, else of the
model's buffers or of the object built for one, else on the card.  Here,
without a card, the module-level default is set to the CPU, so that both
packages compute on the same host arrays.  Bars: those of the JAX tests of
each path (1e-5 for the same float32 recursion, 2e-4 for the affine
smoother, 1e-3 for the associative scan and for VMP by the kernel, 1e-4 for
the fits and the mixtures); integer results exactly; random draws by dtype
and shape only.  Kernel paths run their plain versions here, held to the
Pallas kernels in interpret mode.

Then: an input with no tensor and no device beside it goes to the card (and
raises without one, never computing on the host unasked); a CPU tensor takes
its numpy siblings to the CPU; the port's ``restore`` reads a checkpoint that
the JAX package wrote.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cortex_tpu_torch import checkpoint, diag, models, ops, parallel, serve
from cortex_tpu_torch.dists import Categorical
from cortex_tpu_torch.ops import kernels
from cortex_tpu_torch.utils import tree

from cortex_tpu import checkpoint as jcheckpoint
from cortex_tpu import diag as jdiag
from cortex_tpu import models as jmodels
from cortex_tpu import ops as jops
from cortex_tpu import parallel as jparallel
from cortex_tpu import serve as jserve
from cortex_tpu.dists import Categorical as JCategorical
from cortex_tpu.ops.pallas_hgf import hgf_filter_pallas
from cortex_tpu.ops.pallas_hmm import (hmm_forward_backward_counts_pallas,
                                       hmm_forward_backward_pallas)
from cortex_tpu.ops.pallas_kernels import lgssm_smooth_pallas


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them,
    8-20x slower on small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def on_cpu(monkeypatch):
    """Arrays with no tensor beside them go to the CPU, not to the card."""
    monkeypatch.setattr(tree, "DEFAULT_DEVICE", "cpu")


REPO = Path(__file__).resolve().parents[1]
R, T, K, M, D = 4, 20, 3, 5, 2
EXACT = "exact"  # integer results: equal
DRAW = None  # random draws: dtype and shape


def _reversed(a):
    """``a`` (float64 or int64) as a view that runs backwards in its last axes."""
    return np.asarray(a)[..., ::-1]


def _rng(seed):
    return np.random.default_rng(seed)


Y = _reversed(_rng(0).normal(size=(R, T)).cumsum(-1))
PRIOR = (_rng(1).normal(size=R), np.full(R, 2.0))
PRIOR_0D = (np.array(0.3), np.array(2.0))  # one prior for every replica: the operator's
U = _reversed(np.cumsum(np.repeat([0.05, 0.8], T // 2) * _rng(2).normal(size=(R, T)), -1))
BINARY = _reversed((_rng(3).random((R, T)) < 0.4).astype(np.int64))


def _stochastic(rng, rows, cols):
    a = rng.random((rows, cols)) + 0.2
    return a / a.sum(-1, keepdims=True)


LOG_A = np.log(_stochastic(_rng(4), K, K))
LOG_PI = np.log(np.full(K, 1.0 / K))
LOG_LIK = np.log(_stochastic(_rng(5), K, M)).T[
    np.abs(_rng(6).normal(size=(R, T)).cumsum(-1)).astype(np.int64) % M][:, ::-1]
_SYMBOLS = np.abs(_rng(7).normal(size=(R, T)).cumsum(-1)).astype(np.int64) % M
OBS = _reversed(np.where(_rng(8).random((R, T)) < 0.1, -1, _SYMBOLS))
OBS_DENSE = _reversed(_SYMBOLS)

# (R, 16, D), the points in reverse order.
X_GMM = (_rng(9).normal(size=(R, 16, D)) + 3.0 * _rng(10).integers(0, K, (R, 16, 1)))[:, ::-1]
INIT_MEANS = X_GMM[0, :K]

I2 = np.eye(D)
MV = (np.diag([0.9, 0.8])[::-1, ::-1], I2, I2, 0.5 * I2, np.zeros(D), I2)  # A reversed
Y_MV = _rng(11).normal(size=(R, T, D)).cumsum(1)[:, ::-1]  # (R, T, D), time reversed

SLDS_ARRAYS = dict(Pi=np.array([[0.95, 0.05], [0.05, 0.95]]), A=np.array([0.98, 0.9]),
                   Q=np.array([0.02, 2.0]), H=np.ones(2), R=np.full(2, 0.1))
CHAINS = _reversed(_rng(12).normal(size=(4, 400)).cumsum(-1) * 0.05 + _rng(13).normal(
    size=(4, 400)))
LOG_W = 2.0 * _rng(14).normal(size=50)
LGSSM_PARAMS = dict(A=0.9, Q=0.5, H=2.0, R=0.3)
HGF_PARAMS = dict(kappa=1.0, omega=-2.0, theta=0.05, pi_u=10.0)


def _fits(rng_seed):
    """An LGSSM series of 4 x 40 steps (A 0.8, Q 0.3, R 0.5), float64, reversed."""
    rng = _rng(rng_seed)
    x = np.zeros((R, 40))
    for t in range(40):
        x[:, t] = (0.8 * x[:, t - 1] if t else 0.0) + np.sqrt(0.3) * rng.normal(size=R)
    return _reversed(x + np.sqrt(0.5) * rng.normal(size=(R, 40)))


Y_FIT = _fits(15)


# -- each case: (port result, JAX result) on the same numpy inputs ------------------


def _lgssm():
    return models.LGSSM(**LGSSM_PARAMS), jmodels.LGSSM(**LGSSM_PARAMS)


def _smooth(method, tol):
    def case():
        port, jax_model = _lgssm()
        prior = PRIOR_0D if method == "matmul" else PRIOR
        return port.smooth(Y, prior, method=method), jax_model.smooth(Y, prior, method=method)
    return case, tol


def _lgssm_fused():
    port, _ = _lgssm()
    return (port.smooth(Y, method="fused"),
            lgssm_smooth_pallas(Y, **LGSSM_PARAMS, interpret=True))


def _hmm():
    return models.HMM(K, LOG_PI), jmodels.HMM(K=K, log_pi=LOG_PI)


def _hmm_fused():
    port, jax_model = _hmm()
    got = port.smooth(LOG_LIK, LOG_A, method="fused")
    want = jax_model.smooth(LOG_LIK, LOG_A, method="pallas")
    return ((torch.exp(got.log_gamma), torch.exp(got.log_xi_sum), got.log_evidence),
            (jnp.exp(want.log_gamma), jnp.exp(want.log_xi_sum), want.log_evidence))


def _fit_vmp(method, pooled):
    def case():
        port, jax_model = _hmm()
        obs = OBS_DENSE if method == "fused" else OBS
        got = port.fit_vmp(obs, M, n_iterations=4, pooled=pooled, method=method)
        want = jax_model.fit_vmp(obs, M, n_iterations=4, pooled=pooled,
                                 method="pallas" if method == "fused" else method)
        return ((got.state, got.elbo), (want.state, want.elbo))
    return case


def _hmm_kernel(counts):
    def case():
        lik, A, pi = np.exp(LOG_LIK), np.exp(LOG_A), np.exp(LOG_PI)
        if counts:
            return (ops.hmm_forward_backward_counts_fused(lik, A, pi),
                    hmm_forward_backward_counts_pallas(lik, A, pi, interpret=True))
        return (ops.hmm_forward_backward_fused(lik, A, pi),
                hmm_forward_backward_pallas(lik, A, pi, interpret=True))
    return case


def _hgf_filter(method):
    def case():
        port, jax_model = models.HGF(**HGF_PARAMS), jmodels.HGF(**HGF_PARAMS)
        return (port.filter(U, method=method),
                jax_model.filter(U, method="pallas" if method == "fused" else method))
    return case


def _hgf_step():
    state = tuple(_rng(16).random((4, R)) + 0.5)
    port, jax_model = models.HGF(**HGF_PARAMS), jmodels.HGF(**HGF_PARAMS)
    return (port.step(models.HGFState(*state), U[:, 0]),
            jax_model.step(jmodels.HGFState(*state), U[:, 0]))


def _streamed(session):
    """The HGF filter over the numpy chunks of U, by the stream or the session."""
    def case():
        port, jax_model = models.HGF(**HGF_PARAMS), jmodels.HGF(**HGF_PARAMS)
        chunks = [U[:, i:i + 5] for i in range(0, T, 5)]
        step = lambda st, c: port.filter(c, state=st, tracks=())  # noqa: E731
        jstep = lambda st, c: jax_model.filter(c, state=st, tracks=())  # noqa: E731
        init, jinit = port.init_state((R,), device="cpu"), jax_model.init_state((R,))
        if not session:
            return (parallel.stream_filter(step, chunks, init, device="cpu")[0],
                    jparallel.stream_filter(jstep, chunks, jinit)[0])
        got, want = (parallel.StreamingSession(step, init, device="cpu"),
                     jparallel.StreamingSession(jstep, jinit))
        for chunk in chunks:
            got.push(chunk)
            want.push(chunk)
        return got.flush(), want.flush()
    return case


def _shard():
    """One rank's block of a 1 x 1 mesh is the whole array (jax.device_put)."""
    mesh = parallel.Mesh(("time",), np.arange(1).reshape(1), {"time": 0}, {},
                         torch.device("cpu"))
    return (parallel.shard(Y, parallel.NamedSharding(mesh, parallel.P(None, "time"))),
            jax.device_put(Y))


def _slds():
    port = models.SLDS(**SLDS_ARRAYS, prior=(0.0, 1.0))
    jax_model = jmodels.SLDS(**SLDS_ARRAYS, prior=(0.0, 1.0))
    assert {b.dtype for b in port.buffers()} == {torch.float32}
    return port, jax_model


def _gmm(full):
    def case():
        port = (models.GMMFull if full else models.GMM)(K=K)
        jax_model = (jmodels.GMMFull if full else jmodels.GMM)(K=K)
        return (port.fit(X_GMM, n_iterations=3, init_means=INIT_MEANS),
                jax_model.fit(X_GMM, n_iterations=3, init_means=INIT_MEANS))
    return case


def _mv(method):
    def case():
        port, jax_model = models.MvLGSSM.from_arrays(*MV), jmodels.MvLGSSM.from_arrays(*MV)
        if method == "filter":
            return port.filter(Y_MV), jax.jit(jax_model.filter)(Y_MV)
        if method == "log_evidence":
            return port.log_evidence(Y_MV), jax.jit(jax_model.log_evidence)(Y_MV)
        smooth = jax.jit(jax_model.smooth, static_argnames=("method",))
        return port.smooth(Y_MV, method=method), smooth(Y_MV, method=method)
    return case


def _server(bucketed):
    """A float64 numpy request to a server whose example is float32."""
    def case():
        example = np.zeros((8, T), np.float32)
        fn = lambda y: ops.lgssm_smooth_scan(y, **LGSSM_PARAMS).mean  # noqa: E731
        jfn = lambda y: jops.lgssm_smooth_scan(y, **LGSSM_PARAMS).mean  # noqa: E731
        request = np.concatenate([Y, Y])[:5 if bucketed else 8]
        if bucketed:
            got = serve.BucketedServer(fn, (example,), max_batch=16)
            want = jserve.BucketedServer(jfn, (example,), max_batch=16)
        else:
            got = serve.aot_compile(fn, torch.zeros((8, T)))
            want = jserve.aot_compile(jfn, jnp.zeros((8, T)))
        return got(request), want(request)
    return case


def _map_run_length():
    y = _reversed(np.concatenate([_rng(17).normal(size=(R, 15)),
                                  5.0 + _rng(18).normal(size=(R, 15))], -1))
    got = models.BOCPD(r_max=32).filter(y)
    want = jmodels.BOCPD(r_max=32).filter(y)
    return got.map_run_length, want.map_run_length


def _systematic_indices():
    key = jax.random.PRNGKey(3)
    u = np.float64(np.asarray(jax.random.uniform(key)))
    return (models.particle.systematic_indices(LOG_W, u),
            jax.jit(jmodels.particle.systematic_resample)(key, LOG_W))


def _particle_filter():
    gen, key = torch.Generator().manual_seed(0), jax.random.PRNGKey(0)
    init = _rng(19).normal(size=64)
    got = models.particle_filter(
        gen, Y[0], lambda g, x: 0.9 * x + torch.randn(x.shape, generator=g),
        lambda y_t, x: -0.5 * (y_t - x) ** 2, init)
    want = jmodels.particle_filter(
        key, Y[0], lambda k, x: 0.9 * x + jax.random.normal(k, x.shape),
        lambda y_t, x: -0.5 * (y_t - x) ** 2, init)
    return got, want


CASES = {
    # The LGSSM slice: ops/chains.py and models/lgssm.py (K1).
    "lgssm_smooth_scan": (lambda: (ops.lgssm_smooth_scan(Y, **LGSSM_PARAMS, prior=PRIOR),
                                   jops.lgssm_smooth_scan(Y, **LGSSM_PARAMS, prior=PRIOR)),
                          (1e-5, 1e-5)),
    "lgssm_smooth_assoc": (lambda: (ops.lgssm_smooth_assoc(Y, prior=PRIOR),
                                    jops.lgssm_smooth_assoc(Y, prior=PRIOR)), (1e-3, 1e-3)),
    "lgssm_smooth_matmul": (lambda: (ops.lgssm_smooth_matmul(Y, prior=PRIOR_0D),
                                     jops.lgssm_smooth_matmul(Y, prior=PRIOR_0D)),
                            (2e-4, 2e-4)),
    "lgssm_messages_scan": (lambda: (ops.lgssm_messages_scan(Y), jops.lgssm_messages_scan(Y)),
                            (1e-5, 1e-5)),
    "LGSSM.smooth scan": _smooth("scan", (1e-5, 1e-5)),
    "LGSSM.smooth assoc": _smooth("assoc", (1e-3, 1e-3)),
    "LGSSM.smooth matmul": _smooth("matmul", (2e-4, 2e-4)),
    "LGSSM.smooth fused": (_lgssm_fused, (1e-4, 1e-4)),
    "lgssm_smooth_fused": (lambda: (ops.lgssm_smooth_fused(Y, **LGSSM_PARAMS),
                                    lgssm_smooth_pallas(Y, **LGSSM_PARAMS, interpret=True)),
                           (1e-4, 1e-4)),
    "LGSSM.filter": (lambda: (_lgssm()[0].filter(Y, PRIOR), _lgssm()[1].filter(Y, PRIOR)),
                     (1e-5, 1e-5)),
    "LGSSM.log_evidence": (lambda: (_lgssm()[0].log_evidence(Y, PRIOR),
                                    _lgssm()[1].log_evidence(Y, PRIOR)), (1e-5, 1e-5)),
    "LGSSM.sample": (lambda: (_lgssm()[0].sample(torch.Generator(), T, (R,), np.float64(0.5)),
                              _lgssm()[1].sample(jax.random.PRNGKey(0), T, (R,),
                                                 np.float64(0.5))), DRAW),
    "robust_lgssm_smooth": (lambda: (ops.robust_lgssm_smooth(Y, n_iters=3, prior=PRIOR),
                                     jops.robust_lgssm_smooth(Y, n_iters=3, prior=PRIOR)),
                            (1e-4, 1e-4)),
    # The HMM slice: ops/hmm.py and models/hmm.py (K2, K3).
    "hmm_forward_backward": (lambda: (ops.hmm_forward_backward(LOG_LIK, LOG_A, LOG_PI),
                                      jops.hmm_forward_backward(LOG_LIK, LOG_A, LOG_PI)),
                             (1e-5, 1e-5)),
    "hmm_viterbi": (lambda: (ops.hmm_viterbi(LOG_LIK, LOG_A, LOG_PI),
                             jops.hmm_viterbi(LOG_LIK, LOG_A, LOG_PI)), EXACT),
    "HMM.smooth scan": (lambda: (_hmm()[0].smooth(LOG_LIK, LOG_A),
                                 _hmm()[1].smooth(LOG_LIK, LOG_A)), (1e-5, 1e-5)),
    "HMM.smooth fused": (_hmm_fused, (1e-5, 1e-5)),
    "HMM.viterbi": (lambda: (_hmm()[0].viterbi(LOG_LIK, LOG_A),
                             _hmm()[1].viterbi(LOG_LIK, LOG_A)), EXACT),
    "HMM.fit_vmp scan with gaps": (_fit_vmp("scan", False), (1e-4, 1e-5)),
    "HMM.fit_vmp fused pooled": (_fit_vmp("fused", True), (1e-3, 1e-5)),
    "hmm_forward_backward_fused": (_hmm_kernel(False), (1e-5, 1e-5)),
    "hmm_forward_backward_counts_fused": (_hmm_kernel(True), (1e-5, 1e-5)),
    # The HGF slice: models/hgf.py, hgf_binary.py, fit.py, parallel/streaming.py (K4).
    "HGF.filter scan": (_hgf_filter("scan"), (1e-5, 1e-5)),
    "HGF.filter fused": (_hgf_filter("fused"), (1e-5, 1e-5)),
    # The jitted Pallas call itself refuses float64 numpy: it gets U as float32.
    "hgf_filter_fused": (lambda: (ops.hgf_filter_fused(U, **HGF_PARAMS),
                                  hgf_filter_pallas(U.astype(np.float32), **HGF_PARAMS,
                                                    interpret=True)), (1e-5, 1e-5)),
    "HGF.log_likelihood": (lambda: (models.HGF(**HGF_PARAMS).log_likelihood(U),
                                    jmodels.HGF(**HGF_PARAMS).log_likelihood(U)), (1e-5, 1e-5)),
    "HGF.step": (_hgf_step, (1e-5, 1e-5)),
    "BinaryHGF.filter": (lambda: (models.BinaryHGF().filter(BINARY),
                                  jmodels.BinaryHGF().filter(BINARY)), (1e-5, 1e-5)),
    "fit_lgssm_ml": (lambda: (models.fit_lgssm_ml(Y_FIT, n_steps=5),
                              jmodels.fit_lgssm_ml(Y_FIT, n_steps=5)), (1e-4, 1e-4)),
    "fit_lgssm_ml given init": (
        lambda: (models.fit_lgssm_ml(Y_FIT, n_steps=5, init=models.LGSSMParams(
            *map(np.float64, (0.2, 0.4, -0.3)))),
                 jmodels.fit_lgssm_ml(Y_FIT, n_steps=5, init=jmodels.LGSSMParams(
                     *map(np.float64, (0.2, 0.4, -0.3))))), (1e-4, 1e-4)),
    "fit_lgssm_em": (lambda: (models.fit_lgssm_em(Y_FIT, n_iters=4),
                              jmodels.fit_lgssm_em(Y_FIT, n_iters=4)), (1e-4, 1e-4)),
    "fit_hgf_ml": (lambda: (models.fit_hgf_ml(U, n_steps=4), jmodels.fit_hgf_ml(U, n_steps=4)),
                   (1e-4, 1e-4)),
    "fit_mv_lgssm_ml": (lambda: (models.fit_mv_lgssm_ml(Y_MV, I2, D, n_steps=3),
                                 jmodels.fit_mv_lgssm_ml(Y_MV, I2, D, n_steps=3)),
                        (1e-4, 1e-4)),
    "stream_filter": (_streamed(False), (1e-5, 1e-5)),
    "StreamingSession": (_streamed(True), (1e-5, 1e-5)),
    # The parallel layer, the switching and particle models.
    "shard": (_shard, (0.0, 0.0)),
    "SLDS.filter": (lambda: tuple(m.filter(Y) for m in _slds()), (1e-5, 1e-6)),
    "SLDS.sample": (lambda: (_slds()[0].sample(torch.Generator(), T, (R,)),
                             _slds()[1].sample(jax.random.PRNGKey(0), T, (R,))), DRAW),
    "systematic_indices": (_systematic_indices, EXACT),
    "systematic_resample": (lambda: (models.systematic_resample(torch.Generator(), LOG_W),
                                     jmodels.systematic_resample(jax.random.PRNGKey(0), LOG_W)),
                            DRAW),
    "particle_filter": (_particle_filter, DRAW),
    "rbpf_filter": (lambda: (models.rbpf_filter(torch.Generator(), _slds()[0], Y[0], 32),
                             jmodels.rbpf_filter(jax.random.PRNGKey(0), _slds()[1], Y[0], 32)),
                    DRAW),
    # The mixtures and the vector chains.
    "GMM.fit": (_gmm(False), (1e-4, 1e-4)),
    "GMMFull.fit": (_gmm(True), (1e-4, 1e-4)),
    **{f"MvLGSSM.smooth {m}": (_mv(m), (5e-3 if m == "assoc" else 2e-4,) * 2)
       for m in ("scan", "blocked", "assoc", "matmul", "sqrt")},
    "MvLGSSM.filter": (_mv("filter"), (2e-4, 2e-4)),
    "mv_lgssm_filter": (lambda: (ops.mv_lgssm_filter(Y_MV, *MV[:4], MV[4:]),
                                 jax.jit(jops.mv_lgssm_filter)(Y_MV, *MV[:4], MV[4:])),
                        (2e-4, 2e-4)),
    "MvLGSSM.log_evidence": (_mv("log_evidence"), (1e-4, 1e-4)),
    # Serving, diagnostics, and the zoo's integer results.
    "BucketedServer": (_server(True), (1e-5, 1e-5)),
    "aot_compile": (_server(False), (1e-5, 1e-5)),
    "rhat": (lambda: (diag.rhat(CHAINS), jdiag.rhat(CHAINS)), (1e-5, 1e-5)),
    "ess": (lambda: (diag.ess(CHAINS), jdiag.ess(CHAINS)), (1e-5, 1e-5)),
    "BOCPD map_run_length": (_map_run_length, EXACT),
    "Categorical.sample": (lambda: (Categorical.from_probs(np.full(K, 1.0 / K))
                                    .sample(torch.Generator(), (6,)),
                                    JCategorical.from_probs(np.full(K, 1.0 / K))
                                    .sample(jax.random.PRNGKey(0), (6,))), DRAW),
}


def _leaves(port, ref):
    port_leaves, ref_leaves = tree.tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    return zip(port_leaves, (np.asarray(r) for r in ref_leaves))


@pytest.mark.parametrize("name", list(CASES))
def test_entry_point_takes_and_returns_what_jax_does(name, on_cpu):
    case, tol = CASES[name]
    port, ref = case()
    for got, want in _leaves(port, ref):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert str(got.dtype) == f"torch.{want.dtype}", name
        assert tuple(got.shape) == want.shape, name
        if tol == EXACT:
            np.testing.assert_array_equal(got.numpy(), want)
        elif tol is not DRAW:
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol[0], atol=tol[1])


# -- where arrays go when nothing is patched --------------------------------------------


ALONE = {
    "LGSSM.smooth": lambda: models.LGSSM().smooth(Y),
    "HMM": lambda: models.HMM(K, LOG_PI),
    "HGF.filter": lambda: models.HGF().filter(U, method="fused"),
    "BinaryHGF.filter": lambda: models.BinaryHGF().filter(BINARY),
    "SLDS": lambda: models.SLDS(**SLDS_ARRAYS),
    "GMM.fit": lambda: models.GMM(K=K).fit(X_GMM, n_iterations=1),
    "rhat": lambda: diag.rhat(CHAINS),
    "BucketedServer": lambda: serve.BucketedServer(lambda y: y + 1.0, (Y,)),
}


@pytest.mark.parametrize("name", list(ALONE))
def test_arrays_alone_go_to_the_card_never_to_the_host_unasked(name):
    """With no tensor and no model device beside it, an array goes to the
    card: without one the call raises as torch raises, and computes nothing
    on the host."""
    if torch.cuda.is_available():
        out = ALONE[name]()
        leaves = tree.tree_leaves(out) if not isinstance(out, torch.nn.Module) else list(
            out.buffers())
        assert all(t.device.type == "cuda" for t in leaves if isinstance(t, torch.Tensor))
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
            ALONE[name]()


def test_a_cpu_tensor_takes_its_numpy_siblings_to_the_cpu():
    """The first tensor among the inputs names the device; nothing is patched."""
    y = torch.from_numpy(np.ascontiguousarray(Y, np.float32))
    outs = [
        ops.lgssm_smooth_scan(y, prior=PRIOR),
        ops.hmm_forward_backward(LOG_LIK, torch.from_numpy(LOG_A).float(), LOG_PI),
        models.HMM(K, torch.from_numpy(LOG_PI).float()).smooth(LOG_LIK, LOG_A),
        models.HGF().filter(U, state=models.HGF().init_state((R,), device="cpu")),
        models.SLDS(**dict(SLDS_ARRAYS, Pi=torch.tensor(SLDS_ARRAYS["Pi"]).float())).filter(Y),
        models.GMM(K=K).fit(torch.from_numpy(X_GMM.copy()).float(), 1, init_means=INIT_MEANS),
    ]
    for out in outs:
        for leaf in tree.tree_leaves(out):
            assert leaf.device.type == "cpu" and leaf.dtype in (torch.float32, torch.int32)


def test_restore_reads_a_checkpoint_the_jax_package_wrote(tmp_path):
    tree_ = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": (np.arange(3, dtype=np.int32), [np.float32(2.5), np.ones(4, np.float32)])}
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jax.tree_util.tree_map(jnp.asarray, tree_))
    like = {"a": torch.zeros(2, 3), "b": (torch.zeros(3, dtype=torch.int32),
                                          [torch.zeros(()), torch.zeros(4)])}
    got = checkpoint.restore(path, like)
    for leaf, want in zip(tree.tree_leaves(got), jax.tree_util.tree_leaves(tree_)):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        assert str(leaf.dtype) == f"torch.{np.asarray(want).dtype}"
        np.testing.assert_array_equal(leaf.numpy(), want)
    assert isinstance(got["b"], tuple) and isinstance(got["b"][1], list)


def test_chip_smoke_boundary_phase_rehearses_on_cpu(on_cpu):
    """Phase 24 of chip_smoke.py at a small size: every numpy-fed call on
    the CPU, in float32 (the path: int32), equal bit for bit to the call fed
    the tensors that numpy's rounding gives (no launch is counted here: the
    wrappers run their plain versions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = {"lgssm": (40, 30), "hmm": (16, 12, 3, 4), "hgf": (32, 24), "request": 5,
              "chains": (4, 300)}
    server = serve.BucketedServer(lambda y: ops.lgssm_smooth_fused(y),
                                  (torch.zeros((8, 30)),), max_batch=8)
    checks = smoke.run_boundary(torch, models, ops, diag, kernels, server, "cpu",
                                smoke.boundary_data(shapes))
    assert [c["path"] for c in checks] == list(smoke.boundary_calls(models, ops, diag, server))
    for check in checks:
        assert check["bit_equal"] and check["devices"] == ["cpu"] and not check["launches"]
        assert check["dtypes"] == (["torch.int32"] if check["path"] == "HMM.viterbi"
                                   else ["torch.float32"])
