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
version does: 1e-5 (tests/test_hgf.py's bar), bf16 tracks within one ulp;
from a given state too, and a stream of launches, each from the state the
one before left in float32, equals one launch over the whole series.
The time-sharded smoother's CUDA passes and their plain version in float64,
both on the card, differ by float32 rounding: 1e-4 (the K1 bar).
The generic compiled path runs plain torch operations on the card; the BP
chain and the mean-field VMP graph are held against the same calls on the
CPU at 1e-5 and rtol 1e-4 (atol 1e-6).  So do the Gaussian mixtures and the
vector chains, held against the CPU at 1e-4, and the rest of the zoo
(chip_smoke's zoo calls at a small size), against the CPU at chip_smoke's
ZOO_TOL["cpu"] (atol 1e-4, rtol 1e-3); HMC draws from the card's generator,
so it is held to its target's moments instead.  The value layer fed Python
and numpy values (chip_smoke's value phase at a small size) gives, bit for
bit, what its tensor-fed calls give.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from cortex_tpu_torch import models, ops, parallel
from cortex_tpu_torch.models import HGF, HMM, LGSSM, HMMVMPState
from cortex_tpu_torch.ops import kernels, kernels_hgf, kernels_hmm
from cortex_tpu_torch.parallel import StreamingSession, stream_filter, streaming
from cortex_tpu_torch.utils import spans


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


def _hgf_state(seed, R, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(device) for x in (
        rng.normal(size=R), 0.5 + 3 * rng.random(R), rng.normal(size=R), 0.5 + 3 * rng.random(R)))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32-tracks", "bf16-tracks"])
def test_hgf_kernel_from_a_state_matches_plain_version(cuda, bf16):
    """K4 from a given state against its plain version from the same state,
    at the bars of the zero-state cases above."""
    u = _hgf_u(7, (301, 70), cuda)
    state = _hgf_state(8, 301, cuda)
    dtype = torch.bfloat16 if bf16 else torch.float32
    launches = kernels.LAUNCHES["hgf_filter"]
    got = kernels_hgf.hgf_filter_fused(u, **HGF_NONDEFAULT, state=state, track_dtype=dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hgf_filter"] == launches + 1
    want = kernels_hgf.hgf_filter_fused_reference(u, **HGF_NONDEFAULT, state=state,
                                                  track_dtype=dtype)
    zero_state = kernels_hgf.hgf_filter_fused(u, **HGF_NONDEFAULT, track_dtype=dtype)
    for g, w in zip(got[0], want[0]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1], want[1]):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=2**-7 if bf16 else 1e-5, atol=1e-5)
    assert not torch.equal(got[1][0], zero_state[1][0])  # the state was read


@pytest.mark.cuda
def test_hgf_stream_of_kernel_launches_equals_one_launch(cuda):
    """``stream_filter`` over 8 pinned chunks of 32 steps with
    ``method="fused"``: one K4 a chunk and nothing else of the HGF's, each
    from the float32 state the one before wrote, equal bit for bit to one
    launch over the 256 steps (the state is float32 in registers and in
    memory alike)."""
    R, T, chunk = 4096, 256, 32
    u = _hgf_u(9, (R, T), "cpu")
    host = u.reshape(R, T // chunk, chunk).transpose(0, 1).contiguous().pin_memory()
    model = HGF()
    launches = kernels.LAUNCHES["hgf_filter"]
    final, outs = stream_filter(lambda st, c: model.filter(c, state=st, method="fused"),
                                host.unbind(0), model.init_state((R,)))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hgf_filter"] == launches + T // chunk
    whole_final, whole = model.filter(u.to(cuda), method="fused")
    for g, w in zip(final, whole_final):
        assert torch.equal(g, w)
    for field in whole._fields:
        joined = torch.cat([getattr(o, field) for o in outs], dim=1)
        assert torch.equal(joined, getattr(whole, field)), field


@pytest.mark.cuda
def test_a_pinned_chunk_view_is_staged_with_no_host_copy(cuda, monkeypatch):
    """A chunk that is a view of pinned memory is copied to the card as it
    is (no ``pin_memory`` copy on the host), counted in ``copy.h2d`` and in
    the ``stream`` counters."""
    host = torch.randn(8, 64, 32).pin_memory()
    chunk = host[3]
    assert chunk.is_pinned()

    def host_copy(self, *args, **kwargs):
        raise AssertionError("a pinned chunk was copied on the host")

    monkeypatch.setattr(torch.Tensor, "pin_memory", host_copy)
    before = spans.counts()
    staged, done = streaming._Stager(cuda).put(chunk)
    assert done is not None and staged.is_cuda
    torch.cuda.current_stream().wait_event(done)
    assert torch.equal(staged.cpu(), chunk)
    after = spans.counts()
    assert after["copy.h2d.calls"] == before["copy.h2d.calls"] + 1
    assert after["copy.h2d.bytes"] == before["copy.h2d.bytes"] + 64 * 32 * 4
    assert after["stream.chunks"] == before["stream.chunks"] + 1


@pytest.mark.cuda
def test_chip_smoke_hgf_main_path_on_card(cuda):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = kernels.LAUNCHES["hgf_filter"]
    checks = smoke.run_hgf_main_path(torch, models, ops, parallel, "cuda", R=300, T=64, chunk=16,
                                     launches=lambda: kernels.LAUNCHES["hgf_filter"])
    # HGF.filter(method="fused"), the op, and one a chunk in each fused stream.
    assert kernels.LAUNCHES["hgf_filter"] == launches + 2 + 2 * 4
    assert any(c["path"] == "HGF.filter fused" for c in checks)
    assert [c["launches"] for c in checks if c.get("launches") is not None] == [4, 4]


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


# -- the compiled path's captured sweeps ------------------------------------------------


def _graph_counts():
    from cortex_tpu_torch.compile import executor

    return dict(executor._GRAPH)


def _moved(before):
    return {k: n - before[k] for k, n in _graph_counts().items()}


def _eagerly(call):
    """``call()`` with the capture off: the eager sweep on the card."""
    from cortex_tpu_torch.compile import executor

    with pytest.MonkeyPatch.context() as m:
        m.setattr(executor, "_signature", lambda *args: None)
        return call()


def _card_chain(T=16, processor=None):
    from cortex_tpu_torch.compile import CompiledInference

    engine, x, _, _ = models.make_chain_graph(T)
    return CompiledInference(engine, x, processor or models.LGSSMChainBatched()), x


def _chain_family(compiled, x, pack):
    from cortex_tpu_torch.compile import smart_stack

    marginals, _ = compiled.run({}, source_pack=pack, packed=True)
    fam = smart_stack([marginals[v] for v in x])
    return fam.mean, fam.variance


@pytest.mark.cuda
def test_chain_replays_match_the_eager_sweep_and_stay_fresh(cuda):
    """The chain at T = 16, R = 256 on three batches: the first call runs
    eagerly, the second captures, the third replays; each equals the eager
    sweep on its batch, and call k's results are unchanged after call k + 1."""
    compiled, x = _card_chain()
    packs = [_walk(k, (256, 16), cuda).T.contiguous() for k in range(3)]
    before = _graph_counts()
    got, kept = [], []
    for pack in packs:
        got.append(_chain_family(compiled, x, pack))
        kept.append([t.clone() for t in got[-1]])
    assert _moved(before) == {"captures": 1, "replays": 2, "eager": 1}
    for pack, out, want in zip(packs, got, kept):
        for g, k, e in zip(out, want, _eagerly(lambda: _chain_family(compiled, x, pack))):
            assert torch.equal(g, k)  # fresh: untouched by the later calls
            torch.testing.assert_close(g, e, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["iterate", "iterate steady", "fixed_point steady",
                                   "fixed_point dataflow"])
def test_vmp_replays_match_the_eager_sweep(cuda, entry):
    """The mean-field VMP graph (n = 8, R = 64, 4 iterations) with a state
    on the card: its third call replays a graph and matches the eager sweep
    within the bars of tests/test_torch_compile.py (rtol 1e-5, atol 1e-6)."""
    from cortex_tpu_torch.compile import CompiledInference, dep_role_key
    from cortex_tpu_torch.utils import tree

    R, n = 64, 8
    obs = 0.1 * _walk(3, (R, n), cuda)
    engine, x, _, ss, on = models.make_mean_field_ssm_graph(n, list(obs.T), device=cuda)
    compiled = CompiledInference(engine, [ss, on] + x, models.MeanFieldSSMBatched(),
                                 refine_key=dep_role_key)
    state0 = [tree.tree_map(lambda a: a.expand((R,)) if a.dim() == 0 else a, v)
              for v in compiled.initial_state()]
    kind, _, mode = entry.partition(" ")

    def call(k):
        state = [tree.tree_map(lambda a: a * (1.0 + 0.1 * k), v) for v in state0]
        if kind == "iterate":
            return compiled.iterate({}, 4, state, steady_state=mode == "steady")
        return compiled.fixed_point({}, 4, state, mode="dataflow" if mode == "dataflow"
                                    else "steady_state")

    before = _graph_counts()
    outs = [call(k) for k in range(3)]
    assert _moved(before) == {"captures": 1, "replays": 2, "eager": 1}
    for k, (marginals, state) in enumerate(outs):
        want_m, want_s = _eagerly(lambda: call(k))
        got = tree.tree_leaves(([marginals[v] for v in [ss, on] + x], state))
        want = tree.tree_leaves(([want_m[v] for v in [ss, on] + x], want_s))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_a_new_shape_captures_anew_and_the_cap_evicts(cuda, monkeypatch):
    from cortex_tpu_torch.compile import executor

    monkeypatch.setattr(executor, "GRAPH_CAP", 2)
    compiled, x = _card_chain()
    before = _graph_counts()
    for R in (32, 64, 96):  # the third capture evicts R = 32
        for k in range(2):
            _chain_family(compiled, x, _walk(k, (R, 16), cuda).T.contiguous())
    assert _moved(before) == {"captures": 3, "replays": 3, "eager": 3}
    assert [key[2][0][0] for key in compiled._graphs] == [(16, 64), (16, 96)]
    pack = _walk(5, (32, 16), cuda).T.contiguous()
    got = _chain_family(compiled, x, pack)  # R = 32 is first seen again: eager
    assert _moved(before)["eager"] == 4
    for g, w in zip(got, _eagerly(lambda: _chain_family(compiled, x, pack))):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_a_rule_that_reads_the_card_back_stays_eager(cuda):
    """A rule that calls ``.item()`` cannot be captured: its signature runs
    eagerly for good, with the eager values, and the caller's stream is
    restored."""

    class ReadsBack(models.LGSSMChainBatched):
        def compute_message_to_variable(self, engine, variants, dep_values):
            out = super().compute_message_to_variable(engine, variants, dep_values)
            if out.variance.min().item() <= 0.0:
                raise ValueError("a variance is not positive")
            return out

    compiled, x = _card_chain(processor=ReadsBack())
    plain, _ = _card_chain()
    stream = torch.cuda.current_stream()
    before = _graph_counts()
    for k in range(4):
        pack = _walk(k, (128, 16), cuda).T.contiguous()
        got = _chain_family(compiled, x, pack)
        assert torch.cuda.current_stream() == stream
        for g, w in zip(got, _eagerly(lambda: _chain_family(plain, x, pack))):
            assert torch.equal(g, w)
    assert _moved(before) == {"captures": 0, "replays": 0, "eager": 4}
    assert len(compiled._eager) == 1 and not compiled._graphs


@pytest.mark.cuda
def test_an_outer_capture_records_the_eager_sweep_once(cuda):
    """Inside an outer ``torch.cuda.graph`` the sweep is recorded eagerly
    by the outer capture; nothing is captured twice, and the outer graph's
    replays give the eager sweep's values."""
    from cortex_tpu_torch.compile import smart_stack

    compiled, x = _card_chain()
    pack = _walk(0, (128, 16), cuda).T.contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _chain_family(compiled, x, pack)  # warm-up: a first call, eager
    torch.cuda.current_stream().wait_stream(side)
    before = _graph_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        marginals, _ = compiled.run({}, source_pack=pack, packed=True)
    assert _moved(before) == {"captures": 0, "replays": 0, "eager": 0}
    assert not compiled._graphs
    for k in (1, 2):
        fresh = _walk(k, (128, 16), cuda).T.contiguous()
        pack.copy_(fresh)
        graph.replay()
        fam = smart_stack([marginals[v] for v in x])  # its index upload outside the capture
        for g, w in zip((fam.mean, fam.variance),
                        _eagerly(lambda: _chain_family(compiled, x, fresh))):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    assert _moved(before) == {"captures": 0, "replays": 0, "eager": 0}


@pytest.mark.cuda
def test_a_profiled_replay_holds_the_replay_span(cuda, tmp_path):
    import json

    from cortex_tpu_torch.compile import tracing
    from cortex_tpu_torch.utils import spans

    compiled, x = _card_chain()
    for k in range(2):  # eager, then the capture
        _chain_family(compiled, x, _walk(k, (64, 16), cuda).T.contiguous())
    spans.reset()
    with tracing.profile_run(str(tmp_path)):
        _chain_family(compiled, x, _walk(2, (64, 16), cuda).T.contiguous())
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"]}
    assert {"compiled.run", "compiled.replay"} <= names
    (record,) = spans.calls()
    assert record.counts.get("compiled.graph.replays") == 1
    assert "compiled" in record.layers and "rules" not in record.layers


def _fit_counts():
    from cortex_tpu_torch.models import hmm

    return dict(hmm._GRAPH)


def _fit_moved(before):
    return {k: n - before[k] for k, n in _fit_counts().items()}


def _fit_eagerly(call):
    """``call()`` with the fit's capture off: the eager fit on the card."""
    from cortex_tpu_torch.models import hmm

    with pytest.MonkeyPatch.context() as m:
        m.setattr(hmm, "_signature", lambda *args: None)
        return call()


def _fit_leaves(result):
    from cortex_tpu_torch.utils import tree

    return tree.tree_leaves(result)


def _symbols(seed, shape, M, device):
    rng = np.random.default_rng(seed)
    obs = np.abs(rng.normal(size=shape).cumsum(-1)).astype(np.int64) % M
    obs[rng.random(shape) < 0.05] = -1
    return torch.from_numpy(obs).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fused pooled", "scan per replica", "scan init_state"])
def test_fit_replays_match_the_eager_fit_and_stay_fresh(cuda, case):
    """``HMM.fit_vmp`` at R = 256, T = 32, K = 4, M = 8 on three batches:
    the first call runs eagerly, the second captures, the third replays;
    each equals the eager fit on its batch bit for bit, and call k's results
    are unchanged after call k + 1."""
    model = HMM(4, torch.full((4,), -np.log(4.0))).to(cuda)
    method, _, kind = case.partition(" ")
    kwargs = dict(n_iterations=3, method=method, pooled=kind == "pooled")
    if kind == "init_state":
        kwargs["init_state"] = HMMVMPState(
            1.0 + torch.rand((256, 4, 4), generator=torch.Generator().manual_seed(1)).to(cuda),
            1.0 + torch.rand((256, 4, 8), generator=torch.Generator().manual_seed(2)).to(cuda))
    batches = [_symbols(k, (256, 32), 8, cuda) for k in range(3)]
    before = _fit_counts()
    got, kept = [], []
    for obs in batches:
        got.append(model.fit_vmp(obs, 8, **kwargs))
        kept.append([t.clone() for t in _fit_leaves(got[-1])])
    assert _fit_moved(before) == {"captures": 1, "replays": 2, "eager": 1}
    for obs, out, want in zip(batches, got, kept):
        eager = _fit_eagerly(lambda: model.fit_vmp(obs, 8, **kwargs))
        for g, k, e in zip(_fit_leaves(out), want, _fit_leaves(eager)):
            assert torch.equal(g, k)  # fresh: untouched by the later calls
            assert g.stride() == e.stride() and torch.equal(g, e)


@pytest.mark.cuda
@pytest.mark.parametrize("edit", ["reassigned", "edited in place"])
def test_a_replayed_fit_reads_the_models_log_pi(cuda, edit):
    """A replay copies the model's ``log_pi`` in at each call: a buffer
    reassigned or edited after the capture gives the eager fit under it."""
    model = HMM(4, torch.full((4,), -np.log(4.0))).to(cuda)
    obs = _symbols(4, (128, 24), 8, cuda)
    for _ in range(2):  # eager, then the capture
        model.fit_vmp(obs, 8, n_iterations=2, method="fused", pooled=True)
    tilted = torch.log_softmax(torch.tensor([0.5, 0.0, -0.5, 1.0]), 0).to(cuda)
    if edit == "reassigned":
        model.log_pi = tilted
    else:
        model.log_pi.copy_(tilted)
    before = _fit_counts()
    got = model.fit_vmp(obs, 8, n_iterations=2, method="fused", pooled=True)
    assert _fit_moved(before) == {"captures": 0, "replays": 1, "eager": 0}
    want = _fit_eagerly(lambda: model.fit_vmp(obs, 8, n_iterations=2, method="fused",
                                              pooled=True))
    for g, w in zip(_fit_leaves(got), _fit_leaves(want)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_an_outer_capture_records_the_eager_fit_once(cuda):
    """Inside an outer ``torch.cuda.graph`` the fit is recorded eagerly by
    the outer capture; nothing is captured twice, and the outer graph's
    replays give the eager fit's values."""
    model = HMM(4, torch.full((4,), -np.log(4.0))).to(cuda)
    obs = _symbols(0, (128, 24), 8, cuda)

    def fit():
        return model.fit_vmp(obs, 8, n_iterations=2, method="fused", pooled=True)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fit()  # warm-up: a first call, eager
    torch.cuda.current_stream().wait_stream(side)
    before = _fit_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fit()
    assert _fit_moved(before) == {"captures": 0, "replays": 0, "eager": 0}
    assert not model._fits.graphs
    for k in (1, 2):
        obs.copy_(_symbols(k, (128, 24), 8, cuda))
        graph.replay()
        for g, w in zip(_fit_leaves(out), _fit_leaves(_fit_eagerly(fit))):
            assert torch.equal(g, w)
    assert _fit_moved(before) == {"captures": 0, "replays": 0, "eager": 0}


@pytest.mark.cuda
def test_a_profiled_fit_replay_holds_the_replay_span(cuda, tmp_path):
    import json

    from cortex_tpu_torch.compile import tracing
    from cortex_tpu_torch.utils import spans

    model = HMM(4, torch.full((4,), -np.log(4.0))).to(cuda)
    for k in range(2):  # eager, then the capture
        model.fit_vmp(_symbols(k, (64, 16), 8, cuda), 8, n_iterations=2, method="fused",
                      pooled=True)
    spans.reset()
    with tracing.profile_run(str(tmp_path)):
        model.fit_vmp(_symbols(2, (64, 16), 8, cuda), 8, n_iterations=2, method="fused",
                      pooled=True)
    events = {e.get("name"): e for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"] if e.get("name") in ("model.hmm.fit_vmp", "model.hmm.replay")}
    fit, replay = events["model.hmm.fit_vmp"], events["model.hmm.replay"]
    assert fit["ts"] <= replay["ts"]
    assert replay["ts"] + replay["dur"] <= fit["ts"] + fit["dur"]
    (record,) = spans.calls()
    assert record.counts.get("model.hmm.graph.replays") == 1
    assert "model" in record.layers and "ops" not in record.layers
    assert "launch" not in record.layers


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
        # Two time-sharded calls (no prior, prior), three passes each.
        assert r["launches"]["lgssm_time_sharded"] == 6
        assert {"replica-sharded lgssm_smooth_fused", "time-sharded, no prior",
                "time-sharded, prior"} <= {c["path"] for c in r["checks"]}


# (lanes, T, ranks) of the time-sharded passes against their plain version: lanes
# that fill no whole block of threads, blocks of 125 steps (no multiple of 4:
# the scalar loads) and of 80, 32 and 32, middle ranks (3 and 4 ranks), and a
# block cut by the plan itself (8 segments of 256 steps).
TS_SHAPES = [(37, 160, 2), (300, 250, 2), (130, 96, 3), (1, 128, 4), (3_000, 4_096, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("prior", [False, True], ids=["no prior", "prior"])
@pytest.mark.parametrize("params", [(1.0, 1.0, 1.0, 1.0), (0.9, 0.3, 1.0, 1.5)], ids=str)
@pytest.mark.parametrize("min_segment", [1, 300])
@pytest.mark.parametrize("shape", TS_SHAPES, ids=str)
def test_time_sharded_passes_match_the_float64_plain_passes_on_card(
        cuda, shape, min_segment, params, prior, monkeypatch):
    """Every rank of a world of threads on the card (chip_smoke.time_sharded_ranks)
    through the three CUDA passes (a float32 block) and through their plain
    version in float64 (the same block in float64), each rank folding the
    others' gathered elements: the same marginals within float32 rounding
    (the K1 bar, 1e-4), the kernels within 1e-3 of the float64 smoother.
    ``MIN_SEGMENT`` 1 cuts the short blocks into up to 32 segments, empty
    ones included."""
    from cortex_tpu_torch.ops import kernels_time_sharded

    monkeypatch.setattr(kernels_time_sharded, "MIN_SEGMENT", min_segment)
    smoke = _chip_smoke()
    lanes, T, ranks = shape
    y = _walk(T + lanes, (lanes, T), cuda)
    p = None
    if prior:
        rng = np.random.default_rng(lanes)
        p = (torch.from_numpy(rng.normal(size=lanes).astype(np.float32)).to(cuda),
             torch.from_numpy((rng.random(lanes) + 0.5).astype(np.float32)).to(cuda))
    launches = kernels.LAUNCHES["lgssm_time_sharded"]
    got = smoke.time_sharded_ranks(torch, y, ranks, params, p)
    assert kernels.LAUNCHES["lgssm_time_sharded"] == launches + 3 * ranks
    want = smoke.time_sharded_ranks(torch, y.double(), ranks, params,
                                    None if p is None else tuple(q.double() for q in p))
    assert kernels.LAUNCHES["lgssm_time_sharded"] == launches + 3 * ranks
    torch.cuda.synchronize()
    exact = ops.lgssm_smooth_scan(y.cpu().double(), *params,
                                  prior=None if p is None else tuple(q.cpu().double() for q in p))
    for g, w, x in zip(got, want, exact):
        assert w.dtype == torch.float64 and w.is_cuda
        torch.testing.assert_close(g.double(), w, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(g.cpu().double(), x, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_a_time_sharded_call_on_card_launches_three_passes(cuda):
    """One rank's call launches each pass once (``launch.lgssm_time_sharded``
    counts 3) and a strided block is copied before the passes, which take a
    contiguous one only and count nothing when they refuse."""
    from cortex_tpu_torch.ops import kernels_time_sharded
    from cortex_tpu_torch.parallel import time_sharded

    y = _walk(9, (500, 1024), cuda)

    def call(block):
        return time_sharded._sweep(block, 0.9, 0.3, 1.0, 1.5, None, 0, 1, lambda elem: [elem])

    before = kernels.LAUNCHES["lgssm_time_sharded"]
    want = call(y)
    assert kernels.LAUNCHES["lgssm_time_sharded"] == before + 3
    strided = y.t().contiguous().t()
    assert not strided.is_contiguous()
    got = call(strided)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lgssm_time_sharded"] == before + 6
    torch.testing.assert_close(got.mean, want.mean, rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels_time_sharded.LocalSweep(strided, 1.0, 1.0, 1.0, 1.0, first=True, last=True)
    assert kernels.LAUNCHES["lgssm_time_sharded"] == before + 6


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


@pytest.mark.cuda
def test_numpy_inputs_run_on_the_card_as_the_tensor_call(cuda):
    """chip_smoke.py's boundary phase at a small size: float64 and int64
    numpy (reversed views) go to the card as float32 and int32, launch each
    path's kernel (K1, K2, K3 once a VMP iteration and once for the smooth,
    K4) and give, bit for bit, what the tensor-fed call gives."""
    from cortex_tpu_torch import diag, serve

    smoke = _chip_smoke()
    shapes = {"lgssm": (300, 100), "hmm": (64, 64, 4, 8), "hgf": (256, 64), "request": 5,
              "chains": (8, 400)}
    # Captured up front, as phase 22's server is: a request then replays and
    # counts no launch.
    server = serve.BucketedServer(lambda y: ops.lgssm_smooth_fused(y),
                                  (torch.zeros((8, 100), device=cuda),), max_batch=8,
                                  precompile=True)
    checks = smoke.run_boundary(torch, models, ops, diag, kernels, server, "cuda",
                                smoke.boundary_data(shapes))
    launched = {k: sum(c["launches"].get(k, 0) for c in checks) for k in kernels.LAUNCHES}
    assert launched == smoke.BOUNDARY_LAUNCHES
    assert all(c["bit_equal"] and c["devices"] == ["cuda:0"] for c in checks)


@pytest.mark.cuda
def test_values_fed_python_and_numpy_compute_on_the_card(cuda):
    """chip_smoke.py's value phase at a small size: the coin toss fed numpy
    with a prior of Python floats, and every method of every distribution
    and value type of the models fed numpy, on the card, bit for bit what
    the tensor-fed call gives, launching none of K1-K4."""
    from cortex_tpu_torch import compile as port_compile, core, dists

    smoke = _chip_smoke()
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0
    data = smoke.values_data({"star": (500, 20), "replicas": 300, "K": 8, "d": 4,
                              "window": 16, "fit": 64, "gp": 256})
    star = smoke.run_values_star(torch, dists, port_compile, core, "cuda", data["flips"])
    assert star["device"] == "cuda:0"
    checks = smoke.run_values(torch, dists, models, "cuda", data)
    assert all(c["bit_equal"] and set(c["devices"]) <= {"cuda:0"} for c in checks)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.cuda
def test_draws_of_python_values_follow_the_device_rule(cuda):
    """A draw from Python floats is made where the values go, on the card: a
    generator there draws float32 of the shape JAX gives; a CPU generator
    is refused as it is for tensor fields on the card, never moved."""
    from cortex_tpu_torch import dists

    draw = dists.Beta(2.0, 3.0).sample(torch.Generator("cuda").manual_seed(0), (4,))
    assert draw.device.type == "cuda" and draw.dtype == torch.float32 and draw.shape == (4,)
    with pytest.raises(RuntimeError):
        dists.Beta(2.0, 3.0).sample(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        dists.Beta(torch.full((3,), 2.0, device=cuda), 3.0).sample(torch.Generator())
