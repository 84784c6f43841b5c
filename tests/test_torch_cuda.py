"""Card-only tests of the port: the CUDA kernels against their plain versions.

Every test here is marked ``cuda`` and skips without a CUDA card: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor the JAX package,
so it also runs where JAX is absent.  On a machine with a card, from the
root of the checkout (``--noconftest`` because tests/conftest.py sets up JAX)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

The LGSSM kernel and its plain version run the same 1/w formulas in
float32, and differ only where the compiler fuses a multiply and an add:
1e-4 and 1e-3 are the bars of tests/test_pallas_kernels.py, with ample room.
The HMM kernel sums over states in another order than its plain version and
sums the pairwise counts inside its backward pass: gamma atol 1e-5 and
log-evidence rtol 1e-5 (the bars of tests/test_pallas_kernels.py), xi_sum
rtol = atol = 1e-4.  The HGF kernel rounds each operation as its plain
version does: 1e-5 (tests/test_hgf.py's bar), bf16 tracks within one ulp.
The generic compiled path runs plain torch operations on the card; the BP
chain and the mean-field VMP graph are held against the same calls on the
CPU at 1e-5 and rtol 1e-4 (atol 1e-6).  So do the Gaussian mixtures and the
vector chains, held against the CPU at 1e-4, and the rest of the zoo
(chip_smoke's zoo calls at a small size), against the CPU at chip_smoke's
ZOO_TOL["cpu"] (atol 1e-4, rtol 1e-3); HMC draws from the card's generator,
so it is held to its target's moments instead.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from cortex_tpu_torch import models, ops, parallel
from cortex_tpu_torch.models import HGF, HMM, LGSSM
from cortex_tpu_torch.ops import kernels, kernels_hgf, kernels_hmm
from cortex_tpu_torch.parallel import StreamingSession, stream_filter


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
PAIR = kernels_hmm.PAIR
NONDEFAULT = dict(A=0.9, Q=0.5, H=2.0, R=0.7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _walk(seed, shape, device):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=shape).cumsum(axis=-1).astype(np.float32)
    return torch.from_numpy(y).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, params, tol",
    [
        ((300, 100), {}, 1e-4),  # shared-memory path, ragged last block
        ((129, 151), NONDEFAULT, 1e-3),
        ((65, 300), {}, 1e-4),
        ((77, 3072), NONDEFAULT, 1e-3),  # device-memory path
        ((1, 1), {}, 1e-4),
        ((10_000, 101), NONDEFAULT, 1e-3),  # T not a multiple of the 4 segments
        ((64, 3), {}, 1e-4),  # T below the 4 segments: one is empty
        ((33, 1_600), {}, 1e-4),  # 8-replica tile, ragged
        ((500, 200), dict(A=1.3, Q=0.2, H=0.5, R=1.5), 1e-3),  # growing gain products
    ],
)
def test_kernel_matches_plain_version(cuda, shape, params, tol):
    y = _walk(sum(shape), shape, cuda)
    launches = kernels.LAUNCHES["lgssm_smooth"]
    got = kernels.lgssm_smooth_fused(y, **params)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lgssm_smooth"] == launches + 1
    want = kernels.lgssm_smooth_fused_reference(y, **params)
    torch.testing.assert_close(got.mean, want.mean, rtol=tol, atol=tol)
    torch.testing.assert_close(got.variance, want.variance, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_rejects_a_strided_tensor_and_counts_nothing(cuda):
    y = _walk(1, (40, 64), cuda).t()
    launches = kernels.LAUNCHES["lgssm_smooth"]
    with pytest.raises(ValueError, match="contiguous"):
        kernels.lgssm_smooth_fused(y)
    assert kernels.LAUNCHES["lgssm_smooth"] == launches


@pytest.mark.cuda
def test_smoothers_on_card_match_the_cpu(cuda):
    model = LGSSM(**NONDEFAULT)
    y = _walk(2, (50, 40), cuda)
    for method in ("scan", "matmul", "assoc"):
        got = model.smooth(y, method=method)
        want = model.smooth(y.cpu(), method=method)
        torch.testing.assert_close(got.mean.cpu(), want.mean, rtol=2e-4, atol=2e-4)
    fused = ops.lgssm_smooth_fused(y, **NONDEFAULT)
    torch.testing.assert_close(fused.mean.cpu(), model.smooth(y.cpu()).mean,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_chip_smoke_main_path_on_card(cuda):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = kernels.LAUNCHES["lgssm_smooth"]
    checks = smoke.run_main_path(torch, LGSSM, ops, "cuda", R=500, T=60)
    assert kernels.LAUNCHES["lgssm_smooth"] == launches + 1
    assert any(c["path"] == "lgssm_smooth_fused" for c in checks)


def _hmm_inputs(R, T, K, device, seed=0):
    rng = np.random.default_rng(seed)
    lik = (rng.random((R, T, K)) + 0.1).astype(np.float32)
    A = rng.random((K, K)) + 0.2
    A = (A / A.sum(1, keepdims=True)).astype(np.float32)
    pi = np.full(K, 1 / K, dtype=np.float32)
    return [torch.from_numpy(a).to(device) for a in (lik, A, pi)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R, T, K, plan",
    [
        (300, 64, 4, (PAIR, True)),  # the pair path, ragged last block
        (77, 33, 3, (PAIR, True)),  # states past K, T * K off a multiple of 4
        (50, 20, 1, (PAIR, True)),
        (33, 40, 32, (32, True)),
        (65, 500, 4, (4, False)),  # lane groups, alphas through device memory
        (5, 1, 4, (PAIR, True)),  # one step
        (7, 30, 64, (0, True)),  # general path
        (3, 1, 40, (0, True)),
        (4, 300, 200, (0, False)),  # general path, alphas through device memory
        # The pair path's edges: K 5-8, T about the chains' meeting point and
        # odd, R past a block, the longest rows that fit at K=4 and the next
        # (lane groups); K=9 takes lane groups.
        (33, 15, 5, (PAIR, True)),
        (33, 17, 6, (PAIR, True)),
        (33, 33, 7, (PAIR, True)),
        (33, 16, 8, (PAIR, True)),
        (33, 2, 4, (PAIR, True)),
        (33, 3, 4, (PAIR, True)),
        (40, 147, 4, (PAIR, True)),
        (40, 148, 4, (4, True)),
        (33, 17, 9, (16, True)),
    ],
)
def test_hmm_kernels_match_plain_versions(cuda, R, T, K, plan):
    assert kernels_hmm.kernel_plan(T, K) == plan
    lik, A, pi = _hmm_inputs(R, T, K, cuda, seed=R + T + K)
    before = dict(kernels.LAUNCHES)
    k2 = kernels_hmm.hmm_forward_backward_fused(lik, A, pi)
    k3 = kernels_hmm.hmm_forward_backward_counts_fused(lik, A, pi)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hmm_fb"] == before["hmm_fb"] + 1
    assert kernels.LAUNCHES["hmm_fb_counts"] == before["hmm_fb_counts"] + 1
    want = kernels_hmm.hmm_forward_backward_counts_fused_reference(lik, A, pi)
    for got in (k2, k3):
        torch.testing.assert_close(got.gamma, want.gamma, rtol=0, atol=1e-5)
        torch.testing.assert_close(got.log_evidence, want.log_evidence, rtol=1e-5, atol=0)
    torch.testing.assert_close(k3.xi_sum, want.xi_sum, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k3.xi_sum.sum((-2, -1)), torch.full((R,), T - 1.0, device=cuda),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_hmm_kernels_reject_a_strided_tensor_and_count_nothing(cuda):
    lik, A, pi = _hmm_inputs(6, 10, 4, cuda)
    before = dict(kernels.LAUNCHES)
    for fn in (kernels_hmm.hmm_forward_backward_fused,
               kernels_hmm.hmm_forward_backward_counts_fused):
        with pytest.raises(ValueError, match="contiguous"):
            fn(lik.transpose(0, 1), A, pi)
        with pytest.raises(ValueError, match="contiguous"):
            fn(lik, A.t(), pi)
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
def test_hmm_model_on_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(3)
    obs = torch.from_numpy(np.abs(rng.normal(size=(40, 30)).cumsum(-1)).astype(np.int64) % 5)
    obs[rng.random(obs.shape) < 0.05] = -1
    log_pi = torch.log(torch.full((3,), 1 / 3))
    cpu, card = HMM(3, log_pi), HMM(3, log_pi).to(cuda)
    for kwargs in (dict(), dict(pooled=True), dict(pooled=True, method="fused")):
        got = card.fit_vmp(obs.to(cuda), 5, n_iterations=4, **kwargs)
        want = cpu.fit_vmp(obs, 5, n_iterations=4, **kwargs)
        torch.testing.assert_close(got.state.trans_alpha.cpu(), want.state.trans_alpha,
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got.elbo.cpu(), want.elbo, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_chip_smoke_hmm_main_path_on_card(cuda):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    before = dict(kernels.LAUNCHES)
    checks = smoke.run_hmm_main_path(torch, HMM, ops, "cuda", R=300, T=40)
    assert kernels.LAUNCHES["hmm_fb"] == before["hmm_fb"] + 1
    assert kernels.LAUNCHES["hmm_fb_counts"] == before["hmm_fb_counts"] + 1 + smoke.HMM_ITERS
    assert any(c["path"] == "pooled VMP fused" for c in checks)


HGF_NONDEFAULT = dict(kappa=1.4, omega=-3.0, theta=0.2, pi_u=4.0, max_log_nu=8.0, min_pi2=0.05,
                      max_mu2_step=2.0)
HGF_GUARDS = dict(kappa=2.0, omega=-1.0, theta=0.5, pi_u=1000.0, max_log_nu=1.5, min_pi2=0.3,
                  max_mu2_step=0.1)


def _hgf_u(seed, shape, device, noisy=False):
    rng = np.random.default_rng(seed)
    u = 10.0 * rng.normal(size=shape) if noisy else 0.1 * rng.normal(size=shape).cumsum(-1)
    return torch.from_numpy(u.astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, tracks, bf16, params",
    [
        ((300, 100), ops.ALL_TRACKS, False, {}),  # ragged last block and chunk
        ((65, 33), ("mu2", "mu1"), True, {}),
        ((129, 1), (), False, {}),
        ((3, 5000), ops.ALL_TRACKS, False, HGF_NONDEFAULT),  # a T the TPU kernel refused
        ((200, 64), ops.ALL_TRACKS, True, HGF_GUARDS),  # every guard fires
        ((301, 101), ops.ALL_TRACKS, False, {}),  # T off the 16-byte vector: u read by 4 bytes
        ((64, 264), ("pi1", "delta1"), True, {}),  # bf16 tracks, last chunk of 8
    ],
)
def test_hgf_kernel_matches_plain_version(cuda, shape, tracks, bf16, params):
    """Finals and float32 tracks within 1e-5 (tests/test_hgf.py's bar), bf16
    tracks within one bf16 ulp (rtol 2^-7); on an H100 they were equal."""
    u = _hgf_u(sum(shape), shape, cuda, noisy=params is HGF_GUARDS)
    dtype = torch.bfloat16 if bf16 else torch.float32
    launches = kernels.LAUNCHES["hgf_filter"]
    got = kernels_hgf.hgf_filter_fused(u, **params, tracks=tracks, track_dtype=dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hgf_filter"] == launches + 1
    want = kernels_hgf.hgf_filter_fused_reference(u, **params, tracks=tracks, track_dtype=dtype)
    assert len(got[1]) == len(tracks)
    for g, w in zip(got[0], want[0]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1], want[1]):
        assert g.dtype == dtype and g.shape == shape
        torch.testing.assert_close(g, w, rtol=2**-7 if bf16 else 1e-5, atol=1e-5)


@pytest.mark.cuda
def test_hgf_kernel_rejects_what_it_does_not_take_and_counts_nothing(cuda):
    u = _hgf_u(1, (40, 64), cuda)
    launches = kernels.LAUNCHES["hgf_filter"]
    with pytest.raises(ValueError, match="contiguous"):
        kernels_hgf.hgf_filter_fused(u.t())
    with pytest.raises(ValueError, match="unknown tracks"):
        kernels_hgf.hgf_filter_fused(u, tracks=("mu1", "bogus"))
    with pytest.raises(ValueError, match="scan"):
        kernels_hgf.hgf_filter_fused(u, omega=torch.tensor(-2.0, requires_grad=True))
    assert kernels.LAUNCHES["hgf_filter"] == launches


@pytest.mark.cuda
def test_hgf_fused_path_launches_the_kernel(cuda):
    u = _hgf_u(2, (500, 80), cuda)
    model = HGF(**HGF_NONDEFAULT)
    launches = kernels.LAUNCHES["hgf_filter"]
    final, traj = model.filter(u, method="fused", tracks=("pi2", "mu1"))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hgf_filter"] == launches + 1
    scan_final, scan_traj = model.filter(u, tracks=("pi2", "mu1"))
    for g, w in zip(tuple(final) + (traj.pi2, traj.mu1), tuple(scan_final) +
                    (scan_traj.pi2, scan_traj.mu1)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert traj.mu2 is None


class _FailingLibrary:
    """Stands in for the built library: every HGF launch is refused."""

    @staticmethod
    def hgf_filter_f32(*args):
        return 9  # cudaErrorInvalidConfiguration

    @staticmethod
    def lgssm_cuda_error_string(err):
        return b"invalid configuration argument"


@pytest.mark.cuda
def test_hgf_failures_on_the_cuda_path_are_not_swallowed(cuda, monkeypatch):
    """A refused launch or a failed build raises; nothing falls back to the
    plain version, and nothing is counted."""
    u = _hgf_u(3, (10, 20), cuda)
    launches = kernels.LAUNCHES["hgf_filter"]
    monkeypatch.setattr(kernels_hgf, "_library", lambda: _FailingLibrary)
    with pytest.raises(RuntimeError, match="invalid configuration"):
        HGF().filter(u, method="fused")

    def no_nvcc():
        raise RuntimeError("nvcc failed building the kernels")

    monkeypatch.setattr(kernels_hgf, "_library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels_hgf.hgf_filter_fused(u)
    assert kernels.LAUNCHES["hgf_filter"] == launches


@pytest.mark.cuda
def test_streaming_copies_on_a_side_stream_match_the_batch_filter(cuda):
    u = _hgf_u(4, (64, 96), "cpu").numpy()
    model = HGF()
    chunks = [np.ascontiguousarray(u[:, i:i + 16]) for i in range(0, 96, 16)]

    def chunk_step(state, chunk):
        assert chunk.is_cuda
        return model.filter(chunk, state=state, tracks=())

    final, outs = stream_filter(chunk_step, chunks, model.init_state((64,)))
    session = StreamingSession(chunk_step, model.init_state((64,)))
    for chunk in chunks:
        session.push(chunk)
    want, _ = model.filter(torch.from_numpy(u).to(cuda), tracks=())
    for got in (final, session.flush()):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert len(outs) == len(session.outputs) == 6


@pytest.mark.cuda
def test_chip_smoke_hgf_main_path_on_card(cuda):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = kernels.LAUNCHES["hgf_filter"]
    checks = smoke.run_hgf_main_path(torch, models, ops, parallel, "cuda", R=300, T=64, chunk=16)
    assert kernels.LAUNCHES["hgf_filter"] == launches + 2
    assert any(c["path"] == "HGF.filter fused" for c in checks)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
def test_generic_chain_and_vmp_graph_on_card_match_the_cpu(cuda):
    smoke = _chip_smoke()
    y_np, data_np = smoke.generic_data(300, 40)
    card, cpu = smoke.GenericPaths(torch, cuda, 40, 40), smoke.GenericPaths(torch, "cpu", 40, 40)
    y, data = torch.from_numpy(y_np), torch.from_numpy(data_np)
    for got, want in zip(card.bp(y.to(cuda)), cpu.bp(y)):
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for got, want in zip(card.mean_field(data.to(cuda), 4), cpu.mean_field(data, 4)):
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_chip_smoke_generic_main_path_on_card(cuda):
    before = dict(kernels.LAUNCHES)
    checks = _chip_smoke().run_generic_main_path(torch, LGSSM, "cuda", R=500, T=30, n_cpu=64)
    assert len(checks) == 10
    assert kernels.LAUNCHES == before  # the generic path runs none of K1-K4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["GMM", "GMMFull"])
def test_gmm_fits_on_card_match_the_cpu(cuda, name):
    """Both VB-GMMs on the card against the CPU at R=64, N=64 (rtol = atol =
    1e-4, the CPU tests' bar against JAX), and the default initialization's
    pick, made on the CPU, the same on either device."""
    smoke = _chip_smoke()
    x = torch.from_numpy(smoke.gmm_data(64, 64, 2, 4, seed=1))
    cls = getattr(models, name)
    for kwargs in ({"init_means": x[:, :4]}, {}):
        got = cls(K=4).fit(x.to(cuda), n_iterations=6,
                           **{k: v.to(cuda) for k, v in kwargs.items()})
        want = cls(K=4).fit(x, n_iterations=6, **kwargs)
        assert got.free_energy.is_cuda
        for g, w in zip((*got.posterior, got.responsibilities, got.free_energy),
                        (*want.posterior, want.responsibilities, want.free_energy)):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["scan", "blocked", "assoc", "matmul", "sqrt", "auto"])
def test_mv_smoothers_on_card_match_the_cpu(cuda, method):
    """Every ``MvLGSSM.smooth`` method on the card against the CPU at d=3,
    R=32, T=20 (per-component NaN gaps where the method takes them), 1e-4."""
    rng = np.random.default_rng(4)
    A = 0.9 * np.linalg.qr(rng.normal(size=(3, 3)))[0]
    model = models.MvLGSSM.from_arrays(A, 0.5 * np.eye(3), rng.normal(size=(2, 3)),
                                       0.7 * np.eye(2), np.zeros(3), np.eye(3))
    y = rng.normal(size=(32, 20, 2)).cumsum(axis=1).astype(np.float32)
    if method in ("scan", "blocked", "assoc", "auto"):
        y[rng.random(y.shape) < 0.05] = np.nan
    y = torch.from_numpy(y)
    got = model.smooth(y.to(cuda), method=method)
    want = model.smooth(y, method=method)
    assert got.mean.is_cuda
    torch.testing.assert_close(got.mean.cpu(), want.mean, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.cov.cpu(), want.cov, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_chip_smoke_gmm_and_mv_main_paths_on_card(cuda):
    smoke = _chip_smoke()
    before = dict(kernels.LAUNCHES)
    gmm = smoke.run_gmm_main_path(torch, models, ops, "cuda", R=128, N=64, n_ref=16,
                                  chain=(500, 40))
    mv = smoke.run_mv_main_path(torch, models, ops, "cuda", shapes=((2, 64), (5, 16)), T=20,
                                n_ref=8, robust=(500, 40), fit_R=64, fit_steps=2)
    assert len(gmm) == 7 and len(mv) == 20
    assert kernels.LAUNCHES == before  # these paths run none of K1-K4


@pytest.mark.cuda
@pytest.mark.parametrize("backend, world", [("nccl", 1), ("gloo", 2)])
def test_parallel_worlds_on_card_match_the_single_device_path(cuda, tmp_path, backend, world):
    """A 1-rank NCCL world and a 2-rank gloo world (both ranks on the one
    card, exchanges staged through the host): chip_smoke's parallel main path
    at a small size holds every sharded block — replica-sharded K1, the
    time-sharded and pipelined smoothers, the vector chains, the sharded HGF
    with K4 — to the single-device path on the card and to float64 numpy."""
    shapes = {"replica": [300, 40], "time": [64, 128, 2], "mv": [2, 32, 20],
              "hgf": [300, 64, 16], "gabp": [8, 8, 8, 60], "hmc": [8, 3, 100, 100, 8]}
    ranks = _chip_smoke().run_parallel_ranks(
        "parallel_main_path_rank", world, tmp_path, device="cuda", backend=backend,
        timeout=240.0, shapes=shapes, n_ref=16, timed=False)
    for r in ranks:
        assert r["backend"] == backend and r["device"] == "cuda:0"
        assert r["launches"]["lgssm_smooth"] == 1 and r["launches"]["hgf_filter"] == 2
        assert {"replica-sharded lgssm_smooth_fused", "time-sharded, no prior",
                "time-sharded, prior"} <= {c["path"] for c in r["checks"]}


ZOO_SMALL = {"nlssm": (16, 20), "gabp": (4, 8, 8, 60), "hmc": (64, 4, 100, 100, 8),
             "glm": (2000, 8), "ar": (32, 200, 4), "latent_ar": (16, 30), "gp": 300,
             "sgpr": (2000, 32), "gpc": 200, "gpssm": (300, 600), "ppca": (2000, 16, 3, 30),
             "bocpd": (8, 200, 64)}
ZOO_PATHS = ["NonlinearSSM.filter ekf", "NonlinearSSM.smooth ukf", "gabp_grid_solve",
             "gabp_solve", "BayesianLinearRegression.fit", "EPClassifier probit", "cvi logistic",
             "PoissonRegression.fit", "BayesianAR.fit", "latent_ar_smooth", "GP.fit + predict",
             "SGPR.fit + predict", "GPClassifier.fit", "GPSSM matern32", "ppca_closed_form",
             "PPCA.fit_em", "FactorAnalysis.fit_em", "BOCPD GaussianNIG", "BOCPD BernoulliBeta"]


def _float_leaves(tree):
    """The float tensors of a result, less an EP result's site parameters
    (a difference of precisions, ``1/v - tau_cav``: chip_smoke holds the
    posterior they give, not the sites), loadings ``W`` as ``W Wᵀ`` (their
    columns' signs differ between the libraries' factorizations)."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", [None] * len(tree))
        return [leaf for name, item in zip(fields, tree) if name != "ep"
                for leaf in _float_leaves(item @ item.mT if name == "W" else item)]
    return []


@pytest.mark.cuda
@pytest.mark.parametrize("path", ZOO_PATHS)
def test_zoo_models_on_card_match_the_cpu(cuda, path):
    smoke = _chip_smoke()
    data = smoke.zoo_data(ZOO_SMALL)
    got = smoke.zoo_calls(torch, models, ops, "cuda", data, ZOO_SMALL)[path]()
    want = smoke.zoo_calls(torch, models, ops, "cpu", data, ZOO_SMALL)[path]()
    atol, rtol = smoke.ZOO_TOL["cpu"]
    for g, w in zip(_float_leaves(got), _float_leaves(want)):
        assert g.is_cuda
        torch.testing.assert_close(g.cpu(), w, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_gabp_and_hmc_on_card_launch_none_of_the_kernels(cuda):
    smoke = _chip_smoke()
    before = dict(kernels.LAUNCHES)
    eta = torch.randn(3, 8, 8, device=cuda)
    grid = ops.gabp_grid_solve(torch.full((8, 8), 4.0, device=cuda), eta, -0.8, n_iters=60)
    edges = ops.grid_edges(8, 8)
    flat = ops.gabp_solve(torch.full((64,), 4.0, device=cuda), eta.reshape(3, 64), edges,
                          torch.full((len(edges),), -0.8, device=cuda), n_iters=60)
    torch.testing.assert_close(grid.mean.reshape(3, 64), flat.mean, rtol=2e-4, atol=2e-5)
    mu, cov = smoke.hmc_target(4)
    prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32, device=cuda)
    mu = torch.tensor(mu, dtype=torch.float32, device=cuda)
    res = ops.hmc_sample(torch.Generator(device=cuda).manual_seed(0),
                         lambda x: -0.5 * (x - mu) @ (prec @ (x - mu)),
                         torch.zeros(64, 4, device=cuda), n_samples=100, n_warmup=100,
                         n_leapfrog=8, n_chains=64)
    assert res.samples.is_cuda and res.samples.shape == (64, 100, 4)
    smoke.check_hmc(res.samples, res.accept_rate, res.step_size, 4, "HMC on the card")
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
def test_chip_smoke_zoo_main_path_on_card(cuda):
    smoke = _chip_smoke()
    before = dict(kernels.LAUNCHES)
    refs = {"nlssm": 8, "nlssm_cpu": 16, "gabp": 4, "ar": 16, "latent_ar": 8, "cpu_n": 500,
            "gpc_cpu": 100, "bocpd": 4, "bocpd_cpu": 8, "gpssm_stride": 4}
    checks = smoke.run_zoo_main_path(torch, models, ops, "cuda", shapes=ZOO_SMALL, refs=refs)
    assert len(checks) > 60
    assert kernels.LAUNCHES == before  # the zoo runs none of K1-K4


def _card_fn(kernel, device):
    """A function through ``kernel`` and two inputs for it on ``device``."""
    if kernel == "lgssm_smooth":
        return ops.lgssm_smooth_fused, _walk(1, (100, 100), device), _walk(2, (100, 100), device)
    if kernel == "hmm_fb":
        A = torch.tensor([[0.9, 0.1], [0.2, 0.8]], device=device)
        pi = torch.tensor([0.5, 0.5], device=device)
        liks = [torch.from_numpy(np.random.default_rng(s).random((100, 64, 2), dtype=np.float32)
                                 + np.float32(0.1)).to(device) for s in (3, 4)]
        return (lambda lik: kernels_hmm.hmm_forward_backward_fused(lik, A, pi)), *liks
    return ((lambda u: kernels_hgf.hgf_filter_fused(u, tracks=("mu1", "pi2"),
                                                    track_dtype=torch.bfloat16)),
            0.1 * _walk(5, (100, 256), device), 0.1 * _walk(6, (100, 256), device))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lgssm_smooth", "hmm_fb", "hgf_filter"])
def test_a_bucket_captures_its_kernel_once_and_replays_it(cuda, kernel):
    """aot_compile on the card: one launch captured into the graph; a replay
    runs it without Python (the count does not move) and equals the eager
    call; outputs are copies; a request unlike the example raises."""
    from cortex_tpu_torch import serve
    from cortex_tpu_torch.utils.tree import tree_leaves

    fn, x, other = _card_fn(kernel, cuda)
    compiled = serve.aot_compile(fn, x)
    assert compiled.captured_launches[kernel] == 1
    assert sum(compiled.captured_launches.values()) == 1
    first = compiled(x)
    kept = [t.clone() for t in tree_leaves(first)]
    for inp in (other, x):
        launches = kernels.LAUNCHES[kernel]
        got = compiled(inp)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[kernel] == launches
        for g, w in zip(tree_leaves(got), tree_leaves(fn(inp))):
            assert torch.equal(g, w)
    assert all(torch.equal(g, w) for g, w in zip(tree_leaves(first), kept))
    with pytest.raises(TypeError):
        compiled(x[:-1])
    with pytest.raises(TypeError):
        compiled(x.cpu())
    assert compiled.memory_analysis().graph_pool_bytes >= 0
    assert compiled.cost_analysis()["flops"] > 0


@pytest.mark.cuda
def test_export_serialized_k1_loads_and_launches_the_kernel(cuda):
    from cortex_tpu_torch import serve

    y = _walk(7, (1_000, 100), cuda)
    blob = serve.export_serialized(lambda y: tuple(ops.lgssm_smooth_fused(y)), y)
    loaded = serve.load_serialized(blob)
    launches = kernels.LAUNCHES["lgssm_smooth"]
    mean, var = loaded(y)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lgssm_smooth"] == launches + 1
    want = ops.lgssm_smooth_fused(y)
    assert torch.equal(mean, want.mean) and torch.equal(var, want.variance)


@pytest.mark.cuda
def test_chip_smoke_servers_on_card(cuda, tmp_path):
    """chip_smoke.py's servers at a small size: every answer equal to the
    eager call, one launch captured a bucket; and at the phase's size, in a
    fresh process, the kernel named in a profiled replay."""
    from cortex_tpu_torch import serve

    smoke = _chip_smoke()
    shapes = {**smoke.SERVE_SHAPES,
              "lgssm": {"T": 100, "max_batch": 64, "min_bucket": 8, "requests": (3, 9, 64),
                        "precompile": True},
              "hmm": {"T": 64, "K": 4, "M": 8, "max_batch": 64, "min_bucket": 8,
                      "requests": (5, 33)}}
    run = smoke.run_servers(torch, models, ops, serve, "cuda", shapes=shapes, n_ref=8)
    assert run["captured"]["lgssm"] == {8: 1, 16: 1, 32: 1, 64: 1}
    assert all(set(c.values()) == {1} for c in run["captured"].values())
    profiled = smoke.run_replay_profile(tmp_path)
    assert sorted(c["server"] for c in profiled) == sorted(run["servers"])
    assert all(c["replay_ran"] for c in profiled)
