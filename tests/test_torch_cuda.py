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
