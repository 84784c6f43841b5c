"""The scaled HMM forward-backward as a CUDA kernel, beside its plain PyTorch version.

The counterparts of ``cortex_tpu/ops/pallas_hmm.py``:

- :func:`hmm_forward_backward_fused` (``hmm_forward_backward_pallas``):
  state marginals and log-evidence,
- :func:`hmm_forward_backward_counts_fused`
  (``hmm_forward_backward_counts_pallas``): the same plus the summed pairwise
  counts, the whole E-step of Dirichlet VMP.

Both launch ``csrc/hmm_forward_backward.cu`` on a CUDA tensor (built at first
use; a failed build or launch raises) and count the launch in
``kernels.LAUNCHES`` (``"hmm_fb"``, ``"hmm_fb_counts"``), through the
operators ``torch.ops.cortex_tpu_torch.hmm_fb`` and ``hmm_fb_counts``.  On a
CPU tensor they run the plain versions, :func:`hmm_forward_backward_fused_reference`
and :func:`hmm_forward_backward_counts_fused_reference`: the TPU kernel's
scaled recursion with its 1e-30 floors, and the TPU wrapper's formulas for
the counts.  The TPU-only arguments ``tile`` and ``interpret`` are gone.

The recursion runs in linear space: per-step likelihoods below about
``exp(-87)`` are subnormal in float32 and below about ``exp(-104)`` they are
0; where a whole step is 0 the floors take over, while the log-space
:func:`~cortex_tpu_torch.ops.hmm.hmm_forward_backward` stays exact.  That is
the TPU kernel's contract too (XLA flushes subnormals to 0; PyTorch and the
CUDA kernel keep them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..utils import spans
from ..utils.tree import as_tensors
from .chains import _full_float32_matmul
from . import kernels
from .kernels import COSTS, LAUNCHES, NAMESPACE, OPS, SMEM_LIMIT_BYTES, op, row_pitch

__all__ = [
    "HMMFusedPosterior",
    "HMMFusedCounts",
    "hmm_forward_backward_fused",
    "hmm_forward_backward_fused_reference",
    "hmm_forward_backward_counts_fused",
    "hmm_forward_backward_counts_fused_reference",
    "kernel_plan",
    "pair_smem_bytes",
]

FLOOR = 1e-30
PAIR = -1  # kernel_plan's group for the pair path (csrc: group -1)
# Up to PAIR_K_MAX states (padded to 1, 2, 4 or 8, in registers) the pair path
# runs where its rows fit; on an H100 it beat the lane groups at K=4 and 8
# (PERF.md).
PAIR_K_MAX = 8
PAIR_ROWS = 32  # replicas per block of the pair path (csrc: kPairRows)
PAIR_WARPS = 4  # warps per block of the pair path (csrc: kPairWarps)
SMALL_K_MAX = 32  # the lane-group path runs a replica on a group of up to 32 lanes
SMALL_WARPS = 4  # warps per block of the lane-group path (csrc: kSmallBlock / 32)
REDUCE_SLOTS = 32  # csrc: kReduceSlots


class HMMFusedPosterior(NamedTuple):
    gamma: torch.Tensor  # (R, T, K) state marginals
    log_evidence: torch.Tensor  # (R,)


class HMMFusedCounts(NamedTuple):
    gamma: torch.Tensor  # (R, T, K)
    xi_sum: torch.Tensor  # (R, K, K) summed pairwise marginals
    log_evidence: torch.Tensor  # (R,)


def pair_smem_bytes(T: int, K: int) -> int:
    """Shared memory of a block of the pair path (csrc: ``pair_smem_bytes``):
    lik, alpha and b rows of its replicas and the count sums of every warp
    but the first."""
    return 4 * PAIR_ROWS * (3 * row_pitch(T * K) + (PAIR_WARPS - 1) * K * K)


def kernel_plan(T: int, K: int) -> Tuple[int, bool]:
    """How the kernel runs ``T`` steps of ``K`` states: ``(group, alpha_in_smem)``.

    ``group`` is :data:`PAIR` for the pair path (``K <= PAIR_K_MAX`` while
    the rows of lik, alpha and b of its 32 replicas fit in shared memory: a
    warp runs their forward chains and another their backward chains), else
    the lanes of a group that runs one replica (``K`` rounded up to a power
    of two, for ``K <= 32``), or 0 for the general path (one block per
    replica).  ``alpha_in_smem`` says whether the forward messages fit in
    shared memory; otherwise they go through the ``gamma`` output.  Raises
    ``ValueError`` when even the general path's state vectors do not fit.
    """
    if K <= PAIR_K_MAX and pair_smem_bytes(T, K) <= SMEM_LIMIT_BYTES:
        return PAIR, True
    if K <= SMALL_K_MAX:
        group = 1 << (K - 1).bit_length()
        return group, 4 * SMALL_WARPS * 32 * T <= SMEM_LIMIT_BYTES
    vectors = 4 * (4 * K + REDUCE_SLOTS)
    if vectors > SMEM_LIMIT_BYTES:
        raise ValueError(f"K={K} states do not fit the kernel's shared memory")
    return 0, vectors + 4 * T * K <= SMEM_LIMIT_BYTES


def _check(lik: torch.Tensor, A: torch.Tensor, pi: torch.Tensor) -> None:
    if lik.dim() != 3:
        raise ValueError(f"lik must be (R, T, K), got shape {tuple(lik.shape)}")
    if lik.dtype != torch.float32:
        raise TypeError(f"lik must be float32, got {lik.dtype}")
    R, T, K = lik.shape
    if R == 0 or T == 0 or K == 0:
        raise ValueError(f"lik needs a replica, a step and a state, got {tuple(lik.shape)}")
    if tuple(A.shape) != (K, K) or tuple(pi.shape) != (K,):
        raise ValueError(
            f"A must be ({K}, {K}) and pi ({K},), got {tuple(A.shape)} and {tuple(pi.shape)}"
        )
    if A.device != lik.device or pi.device != lik.device:
        raise ValueError(f"lik, A and pi must share a device, got {lik.device}, "
                         f"{A.device}, {pi.device}")


def _normalize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n = x.sum(-1, keepdim=True).clamp_min(FLOOR)
    return x / n, n[..., 0]


def _sweep(lik, A, pi, keep_alpha: bool):
    """The TPU kernel's sweep (pallas_hmm.py:55-104) over all replicas at
    once: ``(gamma, alpha or None, log_evidence)``."""
    T = lik.shape[1]
    gamma = torch.empty_like(lik)
    with _full_float32_matmul():
        a, n = _normalize(pi * lik[:, 0])
        gamma[:, 0] = a
        logz = torch.log(n)
        for t in range(1, T):
            a, n = _normalize((a @ A) * lik[:, t])  # pred[k] = sum_j a[j] A[j, k]
            gamma[:, t] = a
            logz = logz + torch.log(n)
        alpha = gamma.clone() if keep_alpha else None
        b = torch.ones_like(a)
        for t in range(T - 2, -1, -1):
            b, _ = _normalize((lik[:, t + 1] * b) @ A.t())  # b[j] = sum_k A[j, k] w[k]
            gamma[:, t], _ = _normalize(gamma[:, t] * b)
    return gamma, alpha, logz


def hmm_forward_backward_fused_reference(
    lik: torch.Tensor, A: torch.Tensor, pi: torch.Tensor
) -> HMMFusedPosterior:
    """Plain PyTorch version of the kernel without counts: ``lik`` (R, T, K)
    float32 in linear space, ``A`` (K, K) row-stochastic, ``pi`` (K,)."""
    _check(lik, A, pi)
    gamma, _, logz = _sweep(lik, A.to(lik.dtype), pi.to(lik.dtype), keep_alpha=False)
    return HMMFusedPosterior(gamma, logz)


def hmm_forward_backward_counts_fused_reference(
    lik: torch.Tensor, A: torch.Tensor, pi: torch.Tensor
) -> HMMFusedCounts:
    """Plain PyTorch version of the kernel with counts.  ``xi_sum`` comes from
    the alphas and marginals by the TPU wrapper's formulas
    (pallas_hmm.py:237-247): ``beta = gamma / (alpha + eps)``,
    ``xi_sum = A * sum_t (alpha_t / N_t) ⊗ (lik_{t+1} beta_{t+1})``."""
    _check(lik, A, pi)
    A = A.to(lik.dtype)
    gamma, alpha, logz = _sweep(lik, A, pi.to(lik.dtype), keep_alpha=True)
    with _full_float32_matmul():
        beta = gamma / (alpha + FLOOR)  # unnormalized
        w = lik[:, 1:] * beta[:, 1:]  # (R, T-1, K)
        a_prev = alpha[:, :-1]
        N = ((a_prev @ A) * w).sum(-1) + FLOOR  # (R, T-1)
        S = torch.einsum("rtj,rtk->rjk", a_prev / N[..., None], w)
    return HMMFusedCounts(gamma, A * S, logz)


@functools.cache
def _signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with K2's and K3's C signatures declared: lik, A, At, pi,
    gamma, [xi_sum,] log_evidence, R, T, K, group, alpha_in_smem, stream."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hmm_forward_backward_f32.argtypes = [ptr] * 6 + [i64, i32, i32, i32, i32, ptr]
    lib.hmm_forward_backward_f32.restype = i32
    lib.hmm_forward_backward_counts_f32.argtypes = [ptr] * 7 + [i64, i32, i32, i32, i32, ptr]
    lib.hmm_forward_backward_counts_f32.restype = i32
    return lib


def _library() -> ctypes.CDLL:
    """The kernels' one library (:func:`kernels._library`), K2's and K3's
    signatures declared."""
    return _signatures(kernels._library())


def _launch(lik, A, pi, counts: bool):
    """Launch the kernel on operands checked by the caller, and count the
    launch."""
    with spans.span("launch.hmm_fb_counts" if counts else "launch.hmm_fb"):
        if not (lik.is_contiguous() and A.is_contiguous() and pi.is_contiguous()):
            raise ValueError("lik, A and pi must be contiguous")
        R, T, K = lik.shape
        if R >= 2**31 or R * T * K >= 2**62:
            raise ValueError(f"lik of shape {tuple(lik.shape)} is too large for the kernel")
        group, alpha_smem = kernel_plan(T, K)
        lib = _library()
        A = A.to(lik.dtype)
        At = A.t().contiguous() if group == 0 else A  # only the general path reads Aᵀ
        pi = pi.to(lik.dtype)
        gamma = torch.empty_like(lik)
        logz = torch.empty(R, dtype=lik.dtype, device=lik.device)
        xi = torch.empty((R, K, K), dtype=lik.dtype, device=lik.device) if counts else None
        with torch.cuda.device(lik.device):
            stream = torch.cuda.current_stream(lik.device).cuda_stream
            common = (R, T, K, group, int(alpha_smem), stream)
            if counts:
                err = lib.hmm_forward_backward_counts_f32(
                    lik.data_ptr(), A.data_ptr(), At.data_ptr(), pi.data_ptr(),
                    gamma.data_ptr(), xi.data_ptr(), logz.data_ptr(), *common,
                )
            else:
                err = lib.hmm_forward_backward_f32(
                    lik.data_ptr(), A.data_ptr(), At.data_ptr(), pi.data_ptr(),
                    gamma.data_ptr(), logz.data_ptr(), *common,
                )
        if err != 0:
            reason = lib.lgssm_cuda_error_string(err).decode()
            raise RuntimeError(f"hmm_forward_backward kernel launch failed: {reason} ({err})")
        LAUNCHES["hmm_fb_counts" if counts else "hmm_fb"] += 1
        return gamma, xi, logz


OPS.define("hmm_fb(Tensor lik, Tensor A, Tensor pi) -> (Tensor, Tensor)")
OPS.define("hmm_fb_counts(Tensor lik, Tensor A, Tensor pi) -> (Tensor, Tensor, Tensor)")
OPS.impl("hmm_fb", lambda lik, A, pi: tuple(hmm_forward_backward_fused_reference(lik, A, pi)),
         "CPU")
OPS.impl("hmm_fb_counts",
         lambda lik, A, pi: tuple(hmm_forward_backward_counts_fused_reference(lik, A, pi)), "CPU")
OPS.impl("hmm_fb", lambda lik, A, pi: _launch(lik, A, pi, counts=False)[::2], "CUDA")
OPS.impl("hmm_fb_counts", lambda lik, A, pi: _launch(lik, A, pi, counts=True), "CUDA")


_HMM_FB, _HMM_FB_COUNTS = op("hmm_fb"), op("hmm_fb_counts")


def _cost(lik, A, pi, counts: bool):
    """lik, A and pi read, gamma, the log-evidence (and xi_sum) written; about
    4K^2 + 9K operations a replica-step (forward and backward products, sums,
    divisions), 2K^2 + 3K more for the counts."""
    R, T, K = lik.shape
    nbytes = 4.0 * (2 * R * T * K + R + K * K + K + (R * K * K if counts else 0))
    return float(R * T * (4 * K * K + 9 * K + ((2 * K * K + 3 * K) if counts else 0))), nbytes


COSTS["hmm_fb"] = lambda lik, A, pi: _cost(lik, A, pi, counts=False)
COSTS["hmm_fb_counts"] = lambda lik, A, pi: _cost(lik, A, pi, counts=True)


@torch.library.register_fake(f"{NAMESPACE}::hmm_fb", lib=OPS)
def _hmm_fb_fake(lik, A, pi):
    return torch.empty_like(lik), lik.new_empty(lik.shape[:1])


@torch.library.register_fake(f"{NAMESPACE}::hmm_fb_counts", lib=OPS)
def _hmm_fb_counts_fake(lik, A, pi):
    R, _, K = lik.shape
    return torch.empty_like(lik), lik.new_empty((R, K, K)), lik.new_empty((R,))


def _check_device(lik: torch.Tensor) -> None:
    if lik.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the HMM kernel runs on cpu or cuda, not {lik.device}")


def hmm_forward_backward_fused(
    lik: torch.Tensor, A: torch.Tensor, pi: torch.Tensor
) -> HMMFusedPosterior:
    """Scaled forward-backward: ``lik`` (R, T, K) float32 per-step
    likelihoods (linear space), ``A`` (K, K) row-stochastic, ``pi`` (K,), all
    on one device (arrays that are not tensors become float32 there, or on
    the card).  Returns ``(gamma, log_evidence)``."""
    with spans.span("ops.hmm_fb"):
        lik, A, pi = as_tensors(lik, A, pi)
        _check(lik, A, pi)
        _check_device(lik)
        return HMMFusedPosterior(*_HMM_FB(lik, A, pi))


def hmm_forward_backward_counts_fused(
    lik: torch.Tensor, A: torch.Tensor, pi: torch.Tensor
) -> HMMFusedCounts:
    """Scaled forward-backward emitting the state marginals, the summed
    pairwise counts ``xi_sum`` (R, K, K) and the log-evidence.  On the card
    the counts are summed inside the backward pass.  Inputs as
    :func:`hmm_forward_backward_fused` takes them."""
    with spans.span("ops.hmm_fb_counts"):
        lik, A, pi = as_tensors(lik, A, pi)
        _check(lik, A, pi)
        _check_device(lik)
        return HMMFusedCounts(*_HMM_FB_COUNTS(lik, A, pi))
