"""The port's HGF filter kernel K4 (cortex_tpu_torch.ops.kernels_hgf).

On the CPU the wrapper runs the kernel's plain PyTorch version, which is held
against the JAX Pallas kernel in interpret mode, as tests/test_hgf.py runs it,
at its bars: finals and float32 tracks within 1e-5 (atol = rtol), bf16 tracks
at atol 2e-2, rtol 1e-2 of the float32 ones, bf16 finals within 1e-6 of the
float32 ones.  The CUDA kernel's arithmetic, operation by operation as
csrc/hgf_filter.cu rounds it, is held bit for bit against the plain version's
step by a float32 numpy twin here; the kernel itself is held against the
plain version by the ``cuda``-marked tests of tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cortex_tpu_torch import ops
from cortex_tpu_torch.ops import kernels, kernels_hgf

from cortex_tpu.models import HGF as JaxHGF
from cortex_tpu.ops.pallas_hgf import ALL_TRACKS as JAX_TRACKS
from cortex_tpu.ops.pallas_hgf import hgf_filter_pallas

DEFAULTS = dict(kappa=1.0, omega=-2.0, theta=0.05, pi_u=10.0, max_log_nu=20.0, min_pi2=1e-2,
                max_mu2_step=5.0)
NONDEFAULT = dict(kappa=1.4, omega=-3.0, theta=0.2, pi_u=4.0, max_log_nu=8.0, min_pi2=0.05,
                  max_mu2_step=2.0)
# On 10 x normal data every guard fires (log-volatility clip, pi2 floor, mu2 step clip).
GUARDS = dict(kappa=2.0, omega=-1.0, theta=0.5, pi_u=1000.0, max_log_nu=1.5, min_pi2=0.3,
              max_mu2_step=0.1)


def _walk(seed, shape, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).cumsum(-1) * scale).astype(np.float32)


def _noisy(seed, shape):
    return (10.0 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _close(port, ref, tol=1e-5):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_tracks_and_step_match_the_jax_package():
    assert ops.ALL_TRACKS == JAX_TRACKS
    rng = np.random.default_rng(0)
    state = [rng.normal(size=7).astype(np.float32), (1 + rng.random(7)).astype(np.float32),
             rng.normal(size=7).astype(np.float32), (1 + rng.random(7)).astype(np.float32)]
    u = rng.normal(size=7).astype(np.float32)
    for params in ({}, NONDEFAULT, GUARDS):
        *port, delta1 = kernels_hgf.hgf_update(
            *map(torch.from_numpy, state), torch.from_numpy(u),
            **{**DEFAULTS, **params})
        ref, ref_delta1 = JaxHGF(**params).step(tuple(map(jnp.asarray, state)), jnp.asarray(u))
        for got, want in zip(port + [delta1], list(ref) + [ref_delta1]):
            _close(got, want)


# (shape, tracks, parameters, data): ragged replicas and T, every track, a
# reordered subset, none, one step, a long T (the row-major TPU kernel),
# non-default parameters and every guard firing.
CASES = [
    ((700, 48), (), {}, "walk"),
    ((700, 48), JAX_TRACKS, {}, "walk"),
    ((33, 50), ("delta1", "mu1", "pi2"), {}, "walk"),
    ((5, 1), JAX_TRACKS, {}, "walk"),
    ((16, 2048), (), {}, "walk"),
    ((40, 64), JAX_TRACKS, NONDEFAULT, "walk"),
    ((40, 64), ("mu2", "pi2"), GUARDS, "noisy"),
]
IDS = ["ragged-filter-only", "ragged-all", "reordered", "T1", "long-T", "nondefault", "guards"]


@pytest.mark.parametrize("shape, tracks, params, data", CASES, ids=IDS)
def test_plain_version_matches_pallas_interpret(shape, tracks, params, data):
    u = _walk(sum(shape), shape) if data == "walk" else _noisy(sum(shape), shape)
    finals, values = kernels_hgf.hgf_filter_fused_reference(
        torch.from_numpy(u), **params, tracks=tracks)
    ref_finals, ref_values = hgf_filter_pallas(jnp.asarray(u), **params, tracks=tracks)
    assert len(values) == len(tracks)
    for got, want in zip(finals, ref_finals):
        assert got.shape == shape[:1] and got.dtype == torch.float32
        _close(got, want)
    for got, want in zip(values, ref_values):
        assert got.shape == shape and got.dtype == torch.float32
        _close(got, want)


def test_bf16_tracks_match_pallas_interpret():
    """test_hgf.py's bars: bf16 finals within 1e-6 of the float32 ones, bf16
    tracks at atol 2e-2, rtol 1e-2 of the float32 ones; and the port's bf16
    tracks within one bf16 ulp of the Pallas kernel's."""
    u = _walk(6, (9, 32), scale=0.2)
    ut = torch.from_numpy(u)
    fin32, (mu1_32,) = kernels_hgf.hgf_filter_fused(ut, tracks=("mu1",))
    fin16, (mu2_16, mu1_16) = kernels_hgf.hgf_filter_fused(
        ut, tracks=("mu2", "mu1"), track_dtype=torch.bfloat16)
    assert mu1_16.dtype == mu2_16.dtype == torch.bfloat16
    torch.testing.assert_close(fin16[0], fin32[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(mu1_16.float().numpy(), mu1_32.numpy(), atol=2e-2, rtol=1e-2)
    assert torch.equal(mu1_16, mu1_32.to(torch.bfloat16))
    _, (ref16,) = hgf_filter_pallas(jnp.asarray(u), tracks=("mu1",), track_dtype=jnp.bfloat16)
    ref = np.asarray(ref16, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0**-126))) - 7)
    assert (np.abs(mu1_16.float().numpy() - ref) <= ulp).all()


@pytest.mark.parametrize("tracks, T", [(JAX_TRACKS, 4096), ((), 16_384)])
def test_takes_a_T_that_the_tpu_kernel_refused(tracks, T):
    """The Pallas kernel raises for want of VMEM above T=2,500 with five
    tracks and above T=10,837 with none; the port has no such limit."""
    with pytest.raises(ValueError, match="VMEM"):
        hgf_filter_pallas(jnp.zeros((4, T)), tracks=tracks)
    if not tracks:
        return  # the plain version at T=16,384 would only repeat the next check
    u = _walk(8, (2, T), scale=0.05)
    finals, values = kernels_hgf.hgf_filter_fused(torch.from_numpy(u), tracks=tracks)
    ref_final, ref_traj = JaxHGF().filter(jnp.asarray(u))
    for got, want in zip(finals, ref_final):
        _close(got, want, 1e-4)  # test_hgf.py's bar at T=2,048
    _close(values[0], ref_traj.mu1, 1e-4)


def _kernel_twin(mu1, pi1, mu2, pi2, u, kappa, omega, theta, pi_u, max_log_nu, min_pi2,
                 max_mu2_step):
    """csrc/hgf_filter.cu's step in float32 numpy, one rounding per operation,
    with the host's constants 0.5*kappa^2 and 0.5*kappa rounded once; exp by
    torch, as the plain version computes it."""
    f = np.float32
    log_nu = np.clip(f(kappa) * mu2 + f(omega), f(-max_log_nu), f(max_log_nu))
    nu = torch.exp(torch.from_numpy(log_nu)).numpy()
    pihat1 = f(1) / (f(1) / pi1 + nu)
    pi1_new = pihat1 + f(pi_u)
    inv_pi1 = f(1) / pi1_new
    mu1_new = mu1 + (f(pi_u) * inv_pi1) * (u - mu1)
    d = mu1_new - mu1
    delta1 = (inv_pi1 + d * d) * pihat1 - f(1)
    pihat2 = f(1) / (f(1) / pi2 + f(theta))
    w1 = nu * pihat1
    inner = w1 + (f(2) * w1 - f(1)) * delta1
    pi2_new = np.maximum(pihat2 + (f(0.5 * kappa**2) * w1) * inner, f(min_pi2))
    step = np.clip((f(0.5 * kappa) * (w1 / pi2_new)) * delta1, f(-max_mu2_step),
                   f(max_mu2_step))
    return mu1_new, pi1_new, mu2 + step, pi2_new, delta1


@pytest.mark.parametrize("params", [{}, NONDEFAULT, GUARDS], ids=["default", "nondefault",
                                                                    "guards"])
def test_kernel_arithmetic_matches_plain_step_bit_for_bit(params):
    p = {**DEFAULTS, **params}
    u = _noisy(4, (64, 12)) if params is GUARDS else _walk(4, (64, 12))
    state = [np.zeros(64, np.float32), np.ones(64, np.float32)] * 2
    tstate = [torch.from_numpy(a) for a in state]
    for t in range(u.shape[1]):
        *state, twin_delta1 = _kernel_twin(*state, u[:, t], **p)
        *tstate, delta1 = kernels_hgf.hgf_update(*tstate, torch.from_numpy(u[:, t]), **p)
        for got, want in zip(tstate + [delta1], state + [twin_delta1]):
            np.testing.assert_array_equal(got.numpy(), want)


def _bar_ratio(T):
    """Largest |float32 - float64| / (1e-5 + 1e-5 |float64|) over every state
    and delta1 of T steps of the plain step on 64 walk replicas."""
    u = torch.from_numpy(_walk(4, (64, T)))
    lo = [torch.zeros(64), torch.ones(64)] * 2
    hi = [a.double() for a in lo]
    worst = 0.0
    for t in range(T):
        *lo, d_lo = kernels_hgf.hgf_update(*lo, u[:, t], **DEFAULTS)
        *hi, d_hi = kernels_hgf.hgf_update(*hi, u[:, t].double(), **DEFAULTS)
        for a, b in zip(lo + [d_lo], hi + [d_hi]):
            worst = max(worst, float(((a.double() - b).abs() / (1e-5 + 1e-5 * b.abs())).max()))
    return worst


def test_a_rounding_difference_outgrows_the_bar_at_long_T():
    """Why K4 rounds every operation as its plain version does: the filter
    carries a rounding difference forward and grows it.  The same step in
    float64 stays within 1e-5 (atol = rtol) of the float32 one over 512 steps
    but not over 4,096, so a kernel that rounded otherwise (FMAs, approximate
    reciprocals) could not be held to the plain version at that bar on the
    long-T cases (T = 4,096 and 16,384 in chip_smoke.py)."""
    assert _bar_ratio(512) < 1.0 < _bar_ratio(4096)


def test_wrapper_takes_plain_path_on_cpu_without_counting():
    u = torch.from_numpy(_walk(1, (7, 11)))
    before = dict(kernels.LAUNCHES)
    got = kernels_hgf.hgf_filter_fused(u, tracks=("pi1", "mu1"))
    want = kernels_hgf.hgf_filter_fused_reference(u, tracks=("pi1", "mu1"))
    assert kernels.LAUNCHES == before and "hgf_filter" in kernels.LAUNCHES
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "u, kwargs, error, match",
    [
        (torch.zeros(2, 3, 4), {}, ValueError, "shape"),
        (torch.zeros(0, 4), {}, ValueError, "replica"),
        (torch.zeros(2, 4, dtype=torch.float64), {}, TypeError, "float32"),
        (torch.zeros(2, 4), {"track_dtype": torch.float16}, TypeError, "bfloat16"),
        (torch.zeros(2, 4), {"tracks": ("mu1", "bogus")}, ValueError, "unknown tracks"),
        (torch.zeros(2, 4), {"omega": torch.tensor(-2.0, requires_grad=True)}, ValueError,
         "scan"),
        (torch.zeros(2, 4, device="meta"), {}, ValueError, "cpu or cuda"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(u, kwargs, error, match):
    with pytest.raises(error, match=match):
        kernels_hgf.hgf_filter_fused(u, **kwargs)


def test_a_tensor_parameter_without_grad_is_taken_as_its_number():
    u = torch.from_numpy(_walk(2, (3, 9)))
    got = kernels_hgf.hgf_filter_fused(u, omega=torch.tensor(-3.0), tracks=())
    want = kernels_hgf.hgf_filter_fused(u, omega=-3.0, tracks=())
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
