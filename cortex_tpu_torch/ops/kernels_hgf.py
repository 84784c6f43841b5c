"""The 2-level HGF filter as a CUDA kernel, beside its plain PyTorch version.

:func:`hgf_filter_fused` is the counterpart of
``cortex_tpu.ops.pallas_hgf.hgf_filter_pallas``: the whole T-step filtering
recursion of every replica in one kernel, ``csrc/hgf_filter.cu``, which
reads ``u`` once and writes the final state plus only the requested tracks.
On a CUDA tensor it launches the kernel (built at first use; a failed build
or launch raises) and counts the launch in ``kernels.LAUNCHES["hgf_filter"]``;
on a CPU tensor it runs the plain version, :func:`hgf_filter_fused_reference`.

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

from typing import Sequence, Tuple

import torch

from .kernels import LAUNCHES, _library

__all__ = [
    "ALL_TRACKS",
    "hgf_filter_fused",
    "hgf_filter_fused_reference",
    "hgf_update",
]

ALL_TRACKS = ("mu1", "pi1", "mu2", "pi2", "delta1")
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
):
    """Plain PyTorch version of the kernel: :func:`hgf_update` in a loop over
    ``T`` from the zero state (mu = 0, pi = 1), all replicas at once.  Same
    arguments and results as :func:`hgf_filter_fused`."""
    params = dict(zip(PARAMS, (kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step)))
    tracks, track_dtype, params = _check(u, tracks, track_dtype, params)
    uT = u.t()
    zero = torch.zeros_like(uT[0])
    mu1, pi1, mu2, pi2 = zero, torch.ones_like(zero), zero, torch.ones_like(zero)
    outs = {name: torch.empty_like(uT) for name in tracks}
    for t in range(uT.shape[0]):
        mu1, pi1, mu2, pi2, delta1 = hgf_update(mu1, pi1, mu2, pi2, uT[t], **params)
        step = dict(zip(ALL_TRACKS, (mu1, pi1, mu2, pi2, delta1)))
        for name, out in outs.items():
            out[t] = step[name]
    values = {name: out.t().to(track_dtype).contiguous() for name, out in outs.items()}
    return (mu1, pi1, mu2, pi2), tuple(values[name] for name in tracks)


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
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Filter ``u`` of shape ``(R, T)``, float32, from the zero state.

    Returns ``(finals, track_values)``: the final ``(mu1, pi1, mu2, pi2)``,
    each ``(R,)`` float32, and one ``(R, T)`` tensor per name in ``tracks``
    (a subset of :data:`ALL_TRACKS`, in the caller's order), in
    ``track_dtype`` (float32 or bfloat16; the recursion always runs in
    float32).  Filtering-only callers pass ``tracks=()``: the kernel's output
    traffic grows with the number of tracks.  The parameters are plain
    numbers; a tensor that requires grad raises, since the kernel has no
    backward (use ``HGF.filter(method="scan")``).
    """
    params = dict(zip(PARAMS, (kappa, omega, theta, pi_u, max_log_nu, min_pi2, max_mu2_step)))
    tracks, track_dtype, p = _check(u, tracks, track_dtype, params)
    if u.device.type == "cpu":
        return hgf_filter_fused_reference(u, **p, tracks=tracks, track_dtype=track_dtype)
    if u.device.type != "cuda":
        raise ValueError(f"hgf_filter_fused runs on cpu or cuda, not {u.device}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    R, T = u.shape
    if R >= 2**31 or T >= 2**31:
        raise ValueError(f"u of shape {tuple(u.shape)} is too large for the kernel")
    lib = _library()
    finals = torch.empty((4, R), dtype=u.dtype, device=u.device)
    outs = {name: torch.empty((R, T), dtype=track_dtype, device=u.device) for name in tracks}
    # Output pointers in ALL_TRACKS order; 0 marks a track not written.
    pointers = [outs[name].data_ptr() if name in outs else 0 for name in ALL_TRACKS]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.hgf_filter_f32(
            u.data_ptr(), finals.data_ptr(), *pointers, R, T,
            int(track_dtype == torch.bfloat16),
            # The Python-level constants of the step, rounded once to float32
            # as torch rounds a number that multiplies a float32 tensor.
            p["kappa"], p["omega"], p["theta"], p["pi_u"], p["max_log_nu"], p["min_pi2"],
            p["max_mu2_step"], 0.5 * p["kappa"] ** 2, 0.5 * p["kappa"], stream,
        )
    if err != 0:
        reason = lib.lgssm_cuda_error_string(err).decode()
        raise RuntimeError(f"hgf_filter kernel launch failed: {reason} ({err})")
    LAUNCHES["hgf_filter"] += 1
    return tuple(finals.unbind(0)), tuple(outs[name] for name in tracks)
