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
rtol = atol = 1e-4.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from cortex_tpu_torch import ops
from cortex_tpu_torch.models import HMM, LGSSM
from cortex_tpu_torch.ops import kernels, kernels_hmm

REPO = Path(__file__).resolve().parents[1]
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
        ((65, 300), {}, 1e-4),  # 32-replica tile
        ((77, 3072), NONDEFAULT, 1e-3),  # device-memory path
        ((1, 1), {}, 1e-4),
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
        (300, 64, 4, (4, True)),  # small K, ragged last block
        (77, 33, 3, (4, True)),  # lanes past K
        (50, 20, 1, (1, True)),
        (33, 40, 32, (32, True)),
        (65, 500, 4, (4, False)),  # alphas through device memory
        (5, 1, 4, (4, True)),  # one step
        (7, 30, 64, (0, True)),  # general path
        (3, 1, 40, (0, True)),
        (4, 300, 200, (0, False)),  # general path, alphas through device memory
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
