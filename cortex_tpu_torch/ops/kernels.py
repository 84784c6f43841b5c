"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

:func:`lgssm_smooth_fused` is the counterpart of
``cortex_tpu.ops.pallas_kernels.lgssm_smooth_pallas``: the complete
scalar-LGSSM BP sweep (forward messages, backward messages and marginals) in
one kernel, ``csrc/lgssm_smooth.cu``, which reads ``y`` once and writes the
marginals once.  The precisions of the sweep do not depend on ``y``, so the
kernel takes them precomputed (:func:`sweep_coefficients`) and does one
multiply-add per replica-step each way.  It splits each replica's chain into
:data:`SEGMENTS` time segments, one thread each, joined by the products of
their gains (also precomputed).  On a CPU tensor the wrapper runs the
plain version,
:func:`lgssm_smooth_fused_reference`; on a CUDA tensor it launches the
kernel (building it at first use) or raises.

Each kernel is an operator of the ``cortex_tpu_torch`` namespace
(:data:`OPS`; ``torch.ops.cortex_tpu_torch.*``, :func:`op`): its CPU
implementation is the plain version, its CUDA implementation the kernel's
launch, and its fake implementation gives the output shapes.  So
``torch.export`` traces a kernel into one node of its graph, a CUDA graph
captures its launch, and a saved program loads wherever this package's
``ops`` is imported.

``LAUNCHES`` counts each kernel's launches (this module's and those of
:mod:`~cortex_tpu_torch.ops.kernels_hmm` and
:mod:`~cortex_tpu_torch.ops.kernels_hgf`), so that a run can show that its
path went through the kernels.  A CUDA graph counts its kernels once, when it
is captured: a replay runs them without Python.  :func:`_library` builds and
binds them all.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .chains import ChainMarginals

__all__ = [
    "LAUNCHES",
    "NAMESPACE",
    "OPS",
    "lgssm_smooth_fused",
    "lgssm_smooth_fused_reference",
    "sweep_coefficients",
]

LAUNCHES = {"lgssm_smooth": 0, "hmm_fb": 0, "hmm_fb_counts": 0, "hgf_filter": 0}

# The kernels' operators, in one namespace named after the package
# (``cortex_tpu_torch``; another checkout imported beside it under another
# name, as kernel_probe.py does, gets its own); kernels_hmm and kernels_hgf
# define theirs here too.
NAMESPACE = __name__.split(".")[0]
OPS = torch.library.Library(NAMESPACE, "DEF")


def op(name: str):
    """The operator ``name`` of :data:`NAMESPACE` (its default overload)."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default


# Each operator's ``(operations, bytes)`` from its arguments (shapes only):
# what the kernel must do and move (each input read once, each output
# written once), for ``serve.CompiledFn.cost_analysis``.
COSTS = {}


OPS.define("lgssm_smooth(Tensor y, float A, float Q, float H, float R) -> (Tensor, Tensor)")

# Shared memory one block may opt into on Hopper (227 KB), the replica tiles
# the shared-memory path tries, largest first, and the time segments (threads)
# of each replica there: a warp holds 8 replicas x 4 segments.
SMEM_LIMIT_BYTES = 232_448
SMEM_TILES = (16, 8)
SEGMENTS = 4


def row_pitch(T: int) -> int:
    """Floats per replica row in shared memory: ``T`` rounded up to a multiple
    of 4 (16-byte rows for the bulk copies) that is 4 mod 8, so the eight
    replicas of a warp start on eight distinct 4-bank groups."""
    pitch = -(-T // 4) * 4
    return pitch + 4 if pitch % 8 == 0 else pitch


def segment_length(T: int, segments: int = SEGMENTS) -> int:
    """Steps per time segment: ``ceil(T / segments)``, made odd so that the
    segments of a replica start on banks of distinct parity mod 4.  The last
    segments may be shorter or empty."""
    return -(-T // segments) | 1


def smem_bytes(tile: int, T: int) -> int:
    """Shared memory of one block of the kernel's shared-memory path: its
    mbarrier (16 bytes), two ``(tile, row_pitch(T))`` float32 buffers and the
    five coefficient rows."""
    return 16 + 4 * (2 * tile * row_pitch(T) + 5 * T)


def smem_tile(T: int) -> int:
    """Replicas per block of the kernel's shared-memory path at ``T`` steps.

    Returns 0 when even the smallest tile does not fit; the kernel then keeps
    the forward messages in a time-major scratch in device memory.
    """
    for tile in SMEM_TILES:
        if smem_bytes(tile, T) <= SMEM_LIMIT_BYTES:
            return tile
    return 0


def _check(y: torch.Tensor, A: float) -> None:
    if y.dim() != 2:
        raise ValueError(f"y must be (n_replicas, T), got shape {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise TypeError(f"y must be float32, got {y.dtype}")
    if y.shape[0] == 0 or y.shape[1] == 0:
        raise ValueError(f"y needs a replica and a step, got shape {tuple(y.shape)}")
    if A == 0:
        raise ValueError("the fused sweep divides by A; A must be non-zero")


def lgssm_smooth_fused_reference(
    y: torch.Tensor, A: float = 1.0, Q: float = 1.0, H: float = 1.0, R: float = 1.0
) -> ChainMarginals:
    """Plain PyTorch version of the fused kernel: the same sweep, with the
    kernel's (and the TPU kernel's) 1/w formulas, as a loop over ``T``.

    ``y`` is dense ``(n_replicas, T)`` float32; there is no prior.
    """
    _check(y, A)
    yT = y.t()  # (T, n)
    T = yT.shape[0]
    w_obs = (H * H) / R
    xi_obs = H * yT / R

    # Forward pass: store the forward messages, carry the filtered belief.
    xi_f = torch.zeros_like(xi_obs)
    w_f = torch.zeros_like(xi_obs)
    xi_c, w_c = xi_obs[0], torch.full_like(xi_obs[0], w_obs)
    for t in range(1, T):
        m = xi_c / w_c
        v = 1.0 / w_c
        w_f[t] = 1.0 / (A * A * v + Q)
        xi_f[t] = A * m * w_f[t]
        xi_c = xi_f[t] + xi_obs[t]
        w_c = w_f[t] + w_obs

    # Backward pass: emit the marginals.
    mean = torch.empty_like(xi_obs)
    var = torch.empty_like(xi_obs)
    xi_m = xi_obs[T - 1] + xi_f[T - 1]
    w_m = w_obs + w_f[T - 1]
    mean[T - 1] = xi_m / w_m
    var[T - 1] = 1.0 / w_m
    xi_b, w_b = xi_obs[T - 1], torch.full_like(xi_obs[0], w_obs)
    for t in range(T - 2, -1, -1):
        m = xi_b / w_b
        v = 1.0 / w_b
        w_msg = 1.0 / ((v + Q) / (A * A))
        xi_msg = (m / A) * w_msg
        xi_m = xi_obs[t] + xi_f[t] + xi_msg
        w_m = w_obs + w_f[t] + w_msg
        mean[t] = xi_m / w_m
        var[t] = 1.0 / w_m
        xi_b = xi_obs[t] + xi_msg
        w_b = w_obs + w_msg
    return ChainMarginals(mean.t().contiguous(), var.t().contiguous())


@functools.lru_cache(maxsize=64)
def sweep_coefficients(
    A: float, Q: float, H: float, R: float, T: int, device, segment: int | None = None
) -> torch.Tensor:
    """The data-independent part of the sweep, ``(5, T)`` float32 on ``device``:
    forward gains, backward gains, marginal variances, and the products of
    the gains within each time segment of ``segment`` steps (default ``T``).

    Every precision of the 1/w recursion depends on A, Q, H, R and T only, so
    it runs once here, in float64, with the plain version's formulas:
    ``xi_f[t] = gf[t] * xi_c[t-1]`` (``gf[0] = 0``), ``xi_b[t] = gb[t] *
    xi_bc[t+1]`` (``gb[T-1] = 0``) and ``var[t] = 1 / w_m[t]``, where
    ``xi_c`` and ``xi_bc`` are the information of the filtered belief and of
    the observation times the backward message.  Both are linear in y, so in
    a segment ``[a, b)`` entered with the true ``xi_c[a-1] = c`` and left
    with ``xi_bc[b] = d``, the true values are those of a run from zero
    carries plus ``c * pf[t]`` and ``d * pb[t]``, where ``pf[t] = gf[a] ...
    gf[t]`` and ``pb[t] = gb[t] ... gb[b-1]``: rows 3 and 4.  Cached per
    arguments.
    """
    w_obs = (H * H) / R
    gf, gb, w_f = [0.0] * T, [0.0] * T, [0.0] * T
    w_c = w_obs
    for t in range(1, T):
        w_f[t] = 1.0 / (A * A / w_c + Q)
        gf[t] = A * w_f[t] / w_c
        w_c = w_f[t] + w_obs
    var = [0.0] * T
    var[T - 1] = 1.0 / (w_obs + w_f[T - 1])
    w_b = w_obs
    for t in range(T - 2, -1, -1):
        w_msg = 1.0 / ((1.0 / w_b + Q) / (A * A))
        gb[t] = w_msg / (A * w_b)
        var[t] = 1.0 / (w_obs + w_f[t] + w_msg)
        w_b = w_obs + w_msg
    segment = T if segment is None else segment
    pf, pb = [0.0] * T, [0.0] * T
    for a in range(0, T, segment):
        b = min(a + segment, T)
        prod = 1.0
        for t in range(a, b):
            prod *= gf[t]
            pf[t] = prod
        prod = 1.0
        for t in range(b - 1, a - 1, -1):
            prod *= gb[t]
            pb[t] = prod
    return torch.tensor([gf, gb, var, pf, pb], dtype=torch.float32, device=device)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load()
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # y, mean, var, coef, n, T, tile, pitch, segment, H / R, stream
    lib.lgssm_smooth_smem_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, f32, ptr]
    lib.lgssm_smooth_smem_f32.restype = i32
    lib.lgssm_smooth_global_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, f32, ptr]
    lib.lgssm_smooth_global_f32.restype = i32
    lib.lgssm_cuda_error_string.argtypes = [i32]
    lib.lgssm_cuda_error_string.restype = ctypes.c_char_p
    # lik, A, At, pi, gamma, [xi_sum,] log_evidence, R, T, K, group, alpha_in_smem, stream
    lib.hmm_forward_backward_f32.argtypes = [ptr] * 6 + [i64, i32, i32, i32, i32, ptr]
    lib.hmm_forward_backward_f32.restype = i32
    lib.hmm_forward_backward_counts_f32.argtypes = [ptr] * 7 + [i64, i32, i32, i32, i32, ptr]
    lib.hmm_forward_backward_counts_f32.restype = i32
    # u, finals, five track pointers, R, T, bf16, nine float constants, stream
    lib.hgf_filter_f32.argtypes = [ptr] * 7 + [i64, i32, i32] + [f32] * 9 + [ptr]
    lib.hgf_filter_f32.restype = i32
    return lib


def _lgssm_smooth_cpu(y, A, Q, H, R):
    out = lgssm_smooth_fused_reference(y, A, Q, H, R)
    return out.mean, out.variance


def _lgssm_smooth_cuda(y, A, Q, H, R):
    """Launch ``csrc/lgssm_smooth.cu`` on ``y`` (checked by the caller)."""
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    lib = _library()
    n, T = y.shape
    seg = segment_length(T)
    coef = sweep_coefficients(A, Q, H, R, T, y.device, seg)
    mean = torch.empty_like(y)
    var = torch.empty_like(y)
    tile = smem_tile(T)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        if tile:
            err = lib.lgssm_smooth_smem_f32(
                y.data_ptr(), mean.data_ptr(), var.data_ptr(), coef.data_ptr(),
                n, T, tile, row_pitch(T), seg, H / R, stream,
            )
        else:
            scratch = torch.empty((T, n), dtype=y.dtype, device=y.device)
            err = lib.lgssm_smooth_global_f32(
                y.data_ptr(), mean.data_ptr(), var.data_ptr(), coef.data_ptr(),
                scratch.data_ptr(), n, T, H / R, stream,
            )
    if err != 0:
        reason = lib.lgssm_cuda_error_string(err).decode()
        raise RuntimeError(f"lgssm_smooth kernel launch failed: {reason} ({err})")
    LAUNCHES["lgssm_smooth"] += 1
    return mean, var


OPS.impl("lgssm_smooth", _lgssm_smooth_cpu, "CPU")
OPS.impl("lgssm_smooth", _lgssm_smooth_cuda, "CUDA")
_LGSSM_SMOOTH = op("lgssm_smooth")
# y read, mean and variance written: 12 B a replica-step, and the
# coefficient rows; ~8 operations a replica-step.
COSTS["lgssm_smooth"] = lambda y, *params: (8.0 * y.numel(),
                                             12.0 * y.numel() + 12.0 * y.shape[1])


@torch.library.register_fake(f"{NAMESPACE}::lgssm_smooth", lib=OPS)
def _lgssm_smooth_fake(y, A, Q, H, R):
    return torch.empty_like(y), torch.empty_like(y)


def lgssm_smooth_fused(
    y: torch.Tensor, A: float = 1.0, Q: float = 1.0, H: float = 1.0, R: float = 1.0
) -> ChainMarginals:
    """Fused BP smoothing sweep; ``y``: dense ``(n_replicas, T)`` float32.

    The same marginals as :func:`~cortex_tpu_torch.ops.chains.lgssm_smooth_scan`
    with no prior.  On a CUDA tensor it launches ``csrc/lgssm_smooth.cu``
    (built at first use; a failed build or launch raises) and counts the
    launch in ``LAUNCHES["lgssm_smooth"]``; on a CPU tensor it runs
    :func:`lgssm_smooth_fused_reference`.  Both go through the operator
    ``torch.ops.cortex_tpu_torch.lgssm_smooth``.  The TPU-only arguments of
    ``lgssm_smooth_pallas``, ``tile`` and ``interpret``, are gone: the kernel
    sizes its own tile, and the plain version takes interpret mode's place.
    """
    _check(y, A)
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lgssm_smooth_fused runs on cpu or cuda, not {y.device}")
    mean, var = _LGSSM_SMOOTH(y, float(A), float(Q), float(H), float(R))
    return ChainMarginals(mean, var)
