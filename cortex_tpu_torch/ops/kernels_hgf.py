"""The 2-level HGF filter as a CUDA kernel, beside its plain PyTorch version.

:func:`hgf_filter_fused` is the counterpart of
``cortex_tpu.ops.pallas_hgf.hgf_filter_pallas``: the whole T-step filtering
recursion of every replica in one kernel, ``csrc/hgf_filter.cu``, which
reads ``u`` once and writes the final state plus only the requested tracks.
It starts from the zero state or from a given one (four float32 tensors of
``R``, read once), so a stream of chunks carries each replica's state from
one launch to the next with no copy: one chunk's finals feed the next.
On a CUDA tensor it launches the kernel (built at first use; a failed build
or launch raises) and counts the launch in ``kernels.LAUNCHES["hgf_filter"]``;
on a CPU tensor it runs the plain version, :func:`hgf_filter_fused_reference`;
both through the operator ``torch.ops.cortex_tpu_torch.hgf_filter``.

The TPU-only arguments ``tile`` and ``interpret`` are gone, and so is the
VMEM budget: the kernel prefetches ``u`` into registers and writes the tracks
out through shared memory in chunks of steps, so it takes any T.

:func:`hgf_update` is the one HGF step, shared by the plain version and
:meth:`cortex_tpu_torch.models.HGF.step`.  Its divisions are written as the
kernel computes them: ``1 / x`` is the correctly rounded reciprocal, and
``a / x`` for a parameter ``a`` is ``a`` times that reciprocal (what torch
computes for a number over a tensor), so on the card the kernel and the plain
version round alike.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..utils import spans
from ..utils.tree import as_tensors
from . import kernels
from .kernels import COSTS, LAUNCHES, NAMESPACE, OPS, op

__all__ = [
    "ALL_TRACKS",
    "hgf_filter_fused",
    "hgf_filter_fused_reference",
    "hgf_update",
]

ALL_TRACKS = ("mu1", "pi1", "mu2", "pi2", "delta1")
STATE = ALL_TRACKS[:4]
PARAMS = ("kappa", "omega", "theta", "pi_u", "max_log_nu", "min_pi2", "max_mu2_step")
TRACK_DTYPES = (torch.float32, torch.bfloat16)


def hgf_update(mu1, pi1, mu2, pi2, u, kappa, omega, theta, pi_u, max_log_nu, min_pi2,
               max_mu2_step):
    """One HGF step (models/hgf.py::HGF.step, the Pallas kernel's loop body):
    returns the new ``(mu1, pi1, mu2, pi2)`` and the volatility prediction
    error ``delta1``.  Parameters are numbers or tensors; elementwise over
    any batch shape."""
    log_nu = torch.clamp(kappa * mu2 + omega, -max_log_nu, max_log_nu)
    nu = torch.exp(log_nu)
    pihat1 = torch.reciprocal(torch.reciprocal(pi1) + nu)
    pi1_new = pihat1 + pi_u
    mu1_new = mu1 + (pi_u * torch.reciprocal(pi1_new)) * (u - mu1)
    delta1 = (torch.reciprocal(pi1_new) + (mu1_new - mu1) ** 2) * pihat1 - 1.0
    pihat2 = torch.reciprocal(torch.reciprocal(pi2) + theta)
    w1 = nu * pihat1
    pi2_new = pihat2 + 0.5 * kappa**2 * w1 * (w1 + (2.0 * w1 - 1.0) * delta1)
    pi2_new = torch.clamp(pi2_new, min=min_pi2)
    mu2_step = torch.clamp(
        0.5 * kappa * (w1 / pi2_new) * delta1, -max_mu2_step, max_mu2_step
    )
    return mu1_new, pi1_new, mu2 + mu2_step, pi2_new, delta1


def _check_state(u: torch.Tensor, state) -> Optional[Tuple[torch.Tensor, ...]]:
    """Check an initial state: ``None``, or four tensors ``(mu1, pi1, mu2,
    pi2)``, each ``(R,)`` float32 on ``u``'s device and needing no grad."""
    if state is None:
        return None
    state = tuple(state)
    if len(state) != 4:
        raise ValueError(f"initial state must hold (mu1, pi1, mu2, pi2), got {len(state)} entries")
    R = u.shape[0]
    for name, x in zip(STATE, state):
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"initial state {name} must be a tensor, got {type(x).__name__}")
        if tuple(x.shape) != (R,):
            raise ValueError(f"initial state {name} must be of shape ({R},), got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"initial state {name} must be float32, got {x.dtype}")
        if x.device != u.device:
            raise ValueError(f"initial state {name} must be on {u.device}, got {x.device}")
        if x.requires_grad:
            raise ValueError(
                f"initial state {name} requires grad; the kernel has no backward: "
                "use method='scan'")
    return state


def _check(u: torch.Tensor, tracks: Sequence[str], track_dtype, params: dict):
    """Check the operands; return the tracks as a tuple, the track dtype and
    the parameters as Python floats."""
    if u.dim() != 2:
        raise ValueError(f"u must be (n_replicas, T), got shape {tuple(u.shape)}")
    if u.dtype != torch.float32:
        raise TypeError(f"u must be float32, got {u.dtype}")
    if u.shape[0] == 0 or u.shape[1] == 0:
        raise ValueError(f"u needs a replica and a step, got shape {tuple(u.shape)}")
    tracks = tuple(tracks)
    unknown = set(tracks) - set(ALL_TRACKS)
    if unknown:
        raise ValueError(f"unknown tracks {sorted(unknown)}; valid: {ALL_TRACKS}")
    track_dtype = u.dtype if track_dtype is None else track_dtype
    if track_dtype not in TRACK_DTYPES:
        raise TypeError(f"track_dtype must be float32 or bfloat16, got {track_dtype}")
    for name, value in params.items():
        if isinstance(value, torch.Tensor) and value.requires_grad:
            raise ValueError(
                f"hgf_filter_fused parameter {name!r} requires grad; the kernel "
                "takes plain numbers and has no backward: use method='scan'"
            )
    return tracks, track_dtype, {name: float(value) for name, value in params.items()}


def hgf_filter_fused_reference(
    u: torch.Tensor,
    kappa: float = 1.0,
    omega: float = -2.0,
    theta: float = 0.05,
    pi_u: float = 10.0,
    max_log_nu: float = 20.0,
    min_pi2: float = 1e-2,
    max_mu2_step: float = 5.0,
    tracks: Sequence[str] = ALL_TRACKS,
    track_dtype=None,
    state=None,
):
    """Plain PyTorch version of the kernel: :func:`hgf_update` in a loop over
    ``T`` from ``state`` or the zero state (mu = 0, pi = 1), all replicas at
    once.  Same arguments and results as :func:`hgf_filter_fused`."""
    params = dict(zip(PARAMS, (kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step)))
    tracks, track_dtype, params = _check(u, tracks, track_dtype, params)
    return _filter_plain(u, tracks, track_dtype, params, _check_state(u, state))


def _filter_plain(u, tracks, track_dtype, params, state):
    """:func:`hgf_filter_fused_reference` on checked operands."""
    uT = u.t()
    if state is None:
        zero = torch.zeros_like(uT[0])
        state = zero, torch.ones_like(zero), zero, torch.ones_like(zero)
    mu1, pi1, mu2, pi2 = state
    outs = {name: torch.empty_like(uT) for name in tracks}
    for t in range(uT.shape[0]):
        mu1, pi1, mu2, pi2, delta1 = hgf_update(mu1, pi1, mu2, pi2, uT[t], **params)
        step = dict(zip(ALL_TRACKS, (mu1, pi1, mu2, pi2, delta1)))
        for name, out in outs.items():
            out[t] = step[name]
    values = {name: out.t().to(track_dtype).contiguous() for name, out in outs.items()}
    return (mu1, pi1, mu2, pi2), tuple(values[name] for name in tracks)


def _state_or_none(mu1_0, pi1_0, mu2_0, pi2_0):
    """The operator's four optional state tensors as one state, or ``None``
    when none is given; some but not all raises."""
    state = (mu1_0, pi1_0, mu2_0, pi2_0)
    given = sum(x is not None for x in state)
    if given not in (0, 4):
        raise ValueError(f"the initial state needs all four of {STATE} or none, got {given}")
    return state if given else None


def _hgf_filter_cpu(u, kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step,
                    tracks, bf16, mu1_0=None, pi1_0=None, mu2_0=None, pi2_0=None):
    """The plain version on ``u`` and the state (checked by the caller)."""
    params = dict(zip(PARAMS, (kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step)))
    finals, values = _filter_plain(
        u, [ALL_TRACKS[i] for i in tracks], torch.bfloat16 if bf16 else torch.float32,
        params, _state_or_none(mu1_0, pi1_0, mu2_0, pi2_0))
    return torch.stack(finals), list(values)


@functools.cache
def _signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with K4's C signature declared: u, finals, five track
    pointers, four initial-state pointers, R, T, bf16, nine float constants,
    stream."""
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.hgf_filter_f32.argtypes = [ptr] * 11 + [i64, i32, i32] + [f32] * 9 + [ptr]
    lib.hgf_filter_f32.restype = i32
    return lib


def _library() -> ctypes.CDLL:
    """The kernels' one library (:func:`kernels._library`), K4's signature
    declared."""
    return _signatures(kernels._library())


def _hgf_filter_cuda(u, kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step,
                     tracks, bf16, mu1_0=None, pi1_0=None, mu2_0=None, pi2_0=None):
    """Launch ``csrc/hgf_filter.cu`` on ``u`` and the state (checked by the
    caller)."""
    with spans.span("launch.hgf_filter"):
        if not u.is_contiguous():
            raise ValueError("u must be contiguous")
        state = _state_or_none(mu1_0, pi1_0, mu2_0, pi2_0)
        if state is not None and not all(x.is_contiguous() for x in state):
            raise ValueError("the initial state's tensors must be contiguous")
        R, T = u.shape
        if R >= 2**31 or T >= 2**31:
            raise ValueError(f"u of shape {tuple(u.shape)} is too large for the kernel")
        lib = _library()
        track_dtype = torch.bfloat16 if bf16 else torch.float32
        finals = torch.empty((4, R), dtype=u.dtype, device=u.device)
        outs = {ALL_TRACKS[i]: torch.empty((R, T), dtype=track_dtype, device=u.device)
                for i in tracks}
        # Output pointers in ALL_TRACKS order; 0 marks a track not written.
        pointers = [outs[name].data_ptr() if name in outs else 0 for name in ALL_TRACKS]
        # The initial state's pointers; all 0 for the zero state.
        pointers += [x.data_ptr() for x in state] if state is not None else [0] * 4
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            err = lib.hgf_filter_f32(
                u.data_ptr(), finals.data_ptr(), *pointers, R, T, int(bf16),
                # The Python-level constants of the step, rounded once to float32
                # as torch rounds a number that multiplies a float32 tensor.
                kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step,
                0.5 * kappa ** 2, 0.5 * kappa, stream,
            )
        if err != 0:
            reason = lib.lgssm_cuda_error_string(err).decode()
            raise RuntimeError(f"hgf_filter kernel launch failed: {reason} ({err})")
        LAUNCHES["hgf_filter"] += 1
        return finals, [outs[ALL_TRACKS[i]] for i in tracks]


OPS.define(
    "hgf_filter(Tensor u, float kappa, float omega, float theta, float pi_u, float max_log_nu, "
    "float min_pi2, float max_mu2_step, int[] tracks, bool bf16, Tensor? mu1_0=None, "
    "Tensor? pi1_0=None, Tensor? mu2_0=None, Tensor? pi2_0=None) -> (Tensor, Tensor[])")
OPS.impl("hgf_filter", _hgf_filter_cpu, "CPU")
OPS.impl("hgf_filter", _hgf_filter_cuda, "CUDA")
_HGF_FILTER = op("hgf_filter")
# Operations of one replica-step: about 35 float32 adds, multiplies and
# compares, plus one exp and five reciprocals or divisions on the special
# function unit (16 a cycle per SM against 128 float32 lanes), each counted
# as 8.
OPS_PER_STEP = 35 + 8 * 6


def _cost(u, kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step, tracks, bf16,
          mu1_0=None, pi1_0=None, mu2_0=None, pi2_0=None):
    """u and a given initial state read, the finals and the tracks written;
    OPS_PER_STEP a replica-step."""
    R, T = u.shape
    nbytes = 4.0 * R * T + 16.0 * R + len(tracks) * (2 if bf16 else 4) * R * T
    if mu1_0 is not None:
        nbytes += 16.0 * R
    return float(OPS_PER_STEP * R * T), nbytes


COSTS["hgf_filter"] = _cost


@torch.library.register_fake(f"{NAMESPACE}::hgf_filter", lib=OPS)
def _hgf_filter_fake(u, kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step, tracks,
                     bf16, mu1_0=None, pi1_0=None, mu2_0=None, pi2_0=None):
    track_dtype = torch.bfloat16 if bf16 else torch.float32
    return u.new_empty((4, u.shape[0])), [u.new_empty(u.shape, dtype=track_dtype)
                                          for _ in tracks]


def hgf_filter_fused(
    u: torch.Tensor,
    kappa: float = 1.0,
    omega: float = -2.0,
    theta: float = 0.05,
    pi_u: float = 10.0,
    max_log_nu: float = 20.0,
    min_pi2: float = 1e-2,
    max_mu2_step: float = 5.0,
    tracks: Sequence[str] = ALL_TRACKS,
    track_dtype=None,
    state=None,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Filter ``u`` of shape ``(R, T)``, float32, from ``state`` or, when
    it is ``None``, the zero state (mu = 0, pi = 1).

    Returns ``(finals, track_values)``: the final ``(mu1, pi1, mu2, pi2)``,
    each ``(R,)`` float32, and one ``(R, T)`` tensor per name in ``tracks``
    (a subset of :data:`ALL_TRACKS`, in the caller's order), in
    ``track_dtype`` (float32 or bfloat16; the recursion always runs in
    float32).  Filtering-only callers pass ``tracks=()``: the kernel's output
    traffic grows with the number of tracks.  The parameters are plain
    numbers; a tensor that requires grad raises, since the kernel has no
    backward (use ``HGF.filter(method="scan")``).  ``state`` is ``(mu1,
    pi1, mu2, pi2)`` (an :class:`~cortex_tpu_torch.models.HGFState` or any
    four tensors), each ``(R,)`` float32 on ``u``'s device and needing no
    grad; anything else raises ``ValueError``.  The finals of one call are
    views of one ``(4, R)`` tensor, which the next call takes as its state
    as they are.  A ``u`` that is not a tensor becomes float32 on the card.
    """
    u, = as_tensors(u)
    params = dict(zip(PARAMS, (kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step)))
    tracks, track_dtype, p = _check(u, tracks, track_dtype, params)
    state = _check_state(u, state)
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hgf_filter_fused runs on cpu or cuda, not {u.device}")
    finals, values = _HGF_FILTER(u, *(p[name] for name in PARAMS),
                                 [ALL_TRACKS.index(name) for name in tracks],
                                 track_dtype == torch.bfloat16, *(state or ()))
    return tuple(finals.unbind(0)), tuple(values)
