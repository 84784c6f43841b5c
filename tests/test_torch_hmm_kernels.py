"""The port's HMM forward-backward kernels K2 and K3 (cortex_tpu_torch.ops.kernels_hmm).

On the CPU the wrappers run the kernels' plain PyTorch versions, which are
held against the JAX Pallas kernels in interpret mode, as
tests/test_pallas_kernels.py runs them, at its bars: gamma atol 1e-5,
log-evidence rtol 1e-5, xi_sum atol 1e-5 and its total mass rtol 1e-4.  The
CUDA kernel's own arithmetic (the pairwise counts summed inside the backward
pass; on the pair path a reciprocal and K multiplies for each
normalization) is held against the plain version by torch twins here, and
the kernel itself by the ``cuda``-marked tests of tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cortex_tpu_torch.ops import kernels, kernels_hmm

from cortex_tpu.ops.pallas_hmm import (
    hmm_forward_backward_counts_pallas,
    hmm_forward_backward_pallas,
)

FLOOR = 1e-30


def _inputs(R, T, K, seed, underflow=False):
    """``lik`` ~ U(0.1, 1.1), a row-stochastic ``A``, a uniform ``pi``.  With
    ``underflow``, a fifth of the likelihoods and one replica's whole step
    are exp(-120): 0 in float32, where the floors take over.  (Between
    exp(-87) and exp(-104) float32 is subnormal, which XLA on the CPU
    flushes to 0 and PyTorch and CUDA keep, so the test stays below.)"""
    rng = np.random.default_rng(seed)
    lik = (rng.random((R, T, K)) + 0.1).astype(np.float32)
    if underflow:
        log_lik = np.log(lik)
        log_lik[rng.random((R, T, K)) < 0.2] = -120.0
        log_lik[1, T // 2] = -120.0
        lik = np.exp(log_lik).astype(np.float32)
        assert (lik == 0).any() and (lik[1, T // 2] == 0).all()
    A = (rng.random((K, K)) + 0.2).astype(np.float32)
    A /= A.sum(1, keepdims=True)
    return lik, A, np.full(K, 1 / K, dtype=np.float32)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (R, T, K, tile, underflow): ragged R against the tile, K = 1, 2, 4, 7, one
# step, and likelihoods that underflow float32.
CASES = [
    (13, 12, 4, 8, False),
    (6, 9, 1, 4, False),
    (10, 15, 2, 8, False),
    (7, 10, 7, 4, False),
    (5, 1, 3, 4, False),
    (8, 16, 3, 8, True),
]
IDS = ["ragged", "K1", "K2", "K7", "T1", "underflow"]


@pytest.mark.parametrize("R, T, K, tile, underflow", CASES, ids=IDS)
def test_plain_versions_match_pallas_interpret(R, T, K, tile, underflow):
    lik, A, pi = _inputs(R, T, K, seed=R + T + K, underflow=underflow)
    k2 = kernels_hmm.hmm_forward_backward_fused_reference(*_torch(lik, A, pi))
    k3 = kernels_hmm.hmm_forward_backward_counts_fused_reference(*_torch(lik, A, pi))
    j2 = hmm_forward_backward_pallas(jnp.asarray(lik), jnp.asarray(A), jnp.asarray(pi), tile=tile)
    j3 = hmm_forward_backward_counts_pallas(
        jnp.asarray(lik), jnp.asarray(A), jnp.asarray(pi), tile=tile)
    for port, ref in ((k2, j2), (k3, j3)):
        assert port.gamma.shape == (R, T, K) and port.log_evidence.shape == (R,)
        np.testing.assert_allclose(port.gamma.numpy(), np.asarray(ref.gamma), atol=1e-5, rtol=0)
        np.testing.assert_allclose(port.log_evidence.numpy(), np.asarray(ref.log_evidence),
                                   rtol=1e-5)
    assert k3.xi_sum.shape == (R, K, K)
    np.testing.assert_allclose(k3.xi_sum.numpy(), np.asarray(j3.xi_sum), atol=1e-5, rtol=0)
    if not underflow:
        np.testing.assert_allclose(k3.xi_sum.numpy().sum((-2, -1)), T - 1, rtol=1e-4)
    torch.testing.assert_close(k2.gamma, k3.gamma, rtol=0, atol=0)


def _fused_counts_twin(lik, A, pi):
    """The CUDA kernel's arithmetic (csrc/hmm_forward_backward.cu), in float32
    torch ops over all replicas: the forward pass of the plain version, and a
    backward pass that sums ``(alpha_t / N_t) ⊗ w`` as it goes, with
    ``N_t = sum_j alpha_t(j) (A w)(j) + 1e-30``."""
    R, T, K = lik.shape
    alpha = torch.empty_like(lik)
    a = pi * lik[:, 0]
    n = a.sum(-1, keepdim=True).clamp_min(FLOOR)
    alpha[:, 0] = a / n
    logz = torch.log(n[:, 0])
    for t in range(1, T):
        a = (alpha[:, t - 1, :, None] * A).sum(1) * lik[:, t]
        n = a.sum(-1, keepdim=True).clamp_min(FLOOR)
        alpha[:, t] = a / n
        logz = logz + torch.log(n[:, 0])
    gamma = alpha.clone()
    S = torch.zeros(R, K, K)
    b = torch.ones(R, K)
    for t in range(T - 2, -1, -1):
        w = lik[:, t + 1] * b
        u = (A * w[:, None, :]).sum(-1)  # u[j] = sum_k A[j, k] w[k]
        b = u / u.sum(-1, keepdim=True).clamp_min(FLOOR)
        g = alpha[:, t] * b
        gamma[:, t] = g / g.sum(-1, keepdim=True).clamp_min(FLOOR)
        N = (alpha[:, t] * u).sum(-1, keepdim=True) + FLOOR
        S += (alpha[:, t] / N)[:, :, None] * w[:, None, :]
    return gamma, A * S, logz


@pytest.mark.parametrize("R, T, K, underflow", [
    (9, 20, 4, False), (4, 1, 3, False), (5, 12, 1, False), (6, 30, 33, False),
    (8, 16, 3, True),
])
def test_fused_counts_formula_matches_plain_version(R, T, K, underflow):
    """The kernel sums the pairwise counts in its backward pass; the plain
    version rebuilds them from alphas and marginals as the TPU wrapper does.
    One float32 computation rounded two ways: atol 1e-5."""
    lik, A, pi = _torch(*_inputs(R, T, K, seed=3 * R + T, underflow=underflow))
    gamma, xi, logz = _fused_counts_twin(lik, A, pi)
    ref = kernels_hmm.hmm_forward_backward_counts_fused_reference(lik, A, pi)
    torch.testing.assert_close(gamma, ref.gamma, rtol=0, atol=1e-5)
    torch.testing.assert_close(xi, ref.xi_sum, rtol=0, atol=1e-5)
    torch.testing.assert_close(logz, ref.log_evidence, rtol=1e-5, atol=0)


def _reciprocal_twin(lik, A, pi):
    """The pair path's arithmetic (csrc/hmm_forward_backward.cu,
    ``fb_pair_kernel``) in float32 torch ops: every normalization is one
    correctly rounded reciprocal of the floored sum and K multiplies, where
    the plain version divides.  (The kernel sums the counts over t in four
    parts; here in one.)"""
    R, T, K = lik.shape
    alpha = torch.empty_like(lik)
    a = pi * lik[:, 0]
    n = a.sum(-1, keepdim=True).clamp_min(FLOOR)
    alpha[:, 0] = a * (1 / n)
    logz = torch.log(n[:, 0])
    for t in range(1, T):
        a = (alpha[:, t - 1, :, None] * A).sum(1) * lik[:, t]
        n = a.sum(-1, keepdim=True).clamp_min(FLOOR)
        alpha[:, t] = a * (1 / n)
        logz = logz + torch.log(n[:, 0])
    gamma = alpha.clone()
    S = torch.zeros(R, K, K)
    b = torch.ones(R, K)
    for t in range(T - 2, -1, -1):
        w = lik[:, t + 1] * b
        u = (A * w[:, None, :]).sum(-1)
        b = u * (1 / u.sum(-1, keepdim=True).clamp_min(FLOOR))
        g = alpha[:, t] * b
        gamma[:, t] = g * (1 / g.sum(-1, keepdim=True).clamp_min(FLOOR))
        q = alpha[:, t] * (1 / ((alpha[:, t] * u).sum(-1, keepdim=True) + FLOOR))
        S += q[:, :, None] * w[:, None, :]
    return gamma, A * S, logz


@pytest.mark.parametrize("T", [1, 17, 64, 4096])
def test_reciprocal_normalization_stays_within_the_chip_bar(T):
    """The pair path rounds otherwise than the plain version: held to
    it at chip_smoke.py's HMM_TOL, gamma atol 1e-6, log-evidence rtol 1e-6,
    xi_sum atol = rtol 3e-5, out to T=4,096."""
    lik, A, pi = _torch(*_inputs(4, T, 4, seed=T))
    gamma, xi, logz = _reciprocal_twin(lik, A, pi)
    ref = kernels_hmm.hmm_forward_backward_counts_fused_reference(lik, A, pi)
    torch.testing.assert_close(gamma, ref.gamma, rtol=0, atol=1e-6)
    torch.testing.assert_close(logz, ref.log_evidence, rtol=1e-6, atol=0)
    torch.testing.assert_close(xi, ref.xi_sum, rtol=3e-5, atol=3e-5)


def test_wrappers_take_plain_path_on_cpu_without_counting():
    lik, A, pi = _torch(*_inputs(7, 11, 3, seed=1))
    before = dict(kernels.LAUNCHES)
    k2 = kernels_hmm.hmm_forward_backward_fused(lik, A, pi)
    k3 = kernels_hmm.hmm_forward_backward_counts_fused(lik, A, pi)
    assert kernels.LAUNCHES == before
    assert set(kernels.LAUNCHES) >= {"lgssm_smooth", "hmm_fb", "hmm_fb_counts"}
    ref = kernels_hmm.hmm_forward_backward_counts_fused_reference(lik, A, pi)
    for got in (k2, k3):
        assert torch.equal(got.gamma, ref.gamma)
        assert torch.equal(got.log_evidence, ref.log_evidence)
    assert torch.equal(k3.xi_sum, ref.xi_sum)


def _ok():
    return _torch(*_inputs(2, 3, 4, seed=0))


@pytest.mark.parametrize(
    "args, error",
    [
        ((torch.zeros(3, 4), *_ok()[1:]), ValueError),  # wrong rank
        ((torch.zeros(2, 3, 4, dtype=torch.float64), *_ok()[1:]), TypeError),
        ((torch.zeros(2, 3, 4, dtype=torch.float16), *_ok()[1:]), TypeError),
        ((torch.zeros(0, 3, 4), *_ok()[1:]), ValueError),
        ((_ok()[0], torch.ones(3, 3), _ok()[2]), ValueError),  # A of another K
        ((_ok()[0], _ok()[1], torch.ones(3)), ValueError),  # pi of another K
        ((torch.zeros(2, 3, 4, device="meta"), *_ok()[1:]), ValueError),  # devices differ
        ((torch.zeros(2, 3, 4, device="meta"), torch.zeros(4, 4, device="meta"),
          torch.zeros(4, device="meta")), ValueError),  # neither cpu nor cuda
    ],
)
def test_wrappers_reject_what_the_kernel_does_not_take(args, error):
    for fn in (kernels_hmm.hmm_forward_backward_fused,
               kernels_hmm.hmm_forward_backward_counts_fused):
        with pytest.raises(error):
            fn(*args)


PAIR = kernels_hmm.PAIR


@pytest.mark.parametrize(
    "T, K, plan",
    [
        # The pair path for K <= 8 while the rows of lik, alpha and b of its
        # 32 replicas fit in shared memory (T=147 at K=4, 67 at K=8, 604 at
        # K=1); past that the lane groups, their alphas in shared memory up to
        # T=454.
        (64, 1, (PAIR, True)), (64, 2, (PAIR, True)), (64, 3, (PAIR, True)),
        (64, 4, (PAIR, True)), (64, 5, (PAIR, True)), (64, 6, (PAIR, True)),
        (64, 7, (PAIR, True)), (64, 8, (PAIR, True)),
        (147, 4, (PAIR, True)), (148, 4, (4, True)), (454, 4, (4, True)), (455, 4, (4, False)),
        (604, 1, (PAIR, True)), (605, 1, (1, False)), (67, 8, (PAIR, True)), (68, 8, (8, True)),
        # Lane groups for 9 <= K <= 32, a block a replica beyond.
        (64, 9, (16, True)), (64, 17, (32, True)), (64, 32, (32, True)),
        (1, 33, (0, True)), (20, 200, (0, True)), (300, 200, (0, False)),
    ],
)
def test_kernel_plan_covers_every_state_count(T, K, plan):
    assert kernels_hmm.kernel_plan(T, K) == plan
    if K <= kernels_hmm.PAIR_K_MAX:  # the pair path's rule: its rows fit
        fits = kernels_hmm.pair_smem_bytes(T, K) <= kernels.SMEM_LIMIT_BYTES
        assert (plan[0] == PAIR) == fits


def test_kernel_plan_raises_where_state_vectors_exceed_shared_memory():
    kernels_hmm.kernel_plan(1, 14_000)
    with pytest.raises(ValueError, match="shared memory"):
        kernels_hmm.kernel_plan(1, 15_000)
