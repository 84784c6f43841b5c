"""Port parity: the vector-state chains (``ops.chains_mv``), the square-root
and robust smoothers, ``MvLGSSM`` and ``fit_mv_lgssm_ml`` against the JAX
package.

The same numpy inputs go through both packages on the CPU; the JAX functions
run under ``jax.jit`` (the eager dispatch of their scans costs seconds a
call here), which computes what an eager call computes.  Bars: the
sequential paths (scan, filter, log evidence, matmul, sqrt, robust) within
1e-5 of JAX (tighter than the JAX tests' bars against their float64
oracles); the time-parallel paths, whose Hillis–Steele combine tree differs
from XLA's, within 2e-4 (blocked) and 5e-4 (assoc), the bars of
tests/test_chains_mv.py:243 and :388; the float64 oracles at those tests'
own bars; the ML fit's loss trace at rtol 1e-4.
"""

import dataclasses
import functools
import importlib.util
import inspect
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cortex_tpu_torch import convert, models, ops
from cortex_tpu_torch.models import LGSSM, MvLGSSM, MvLGSSMParams, fit_mv_lgssm_ml
from cortex_tpu_torch.ops import chains_mv as P
from cortex_tpu_torch.ops import robust_lgssm_smooth, sqrt_lgssm_filter, sqrt_lgssm_smooth

import cortex_tpu.models as jmodels
from cortex_tpu.models import fit as jfit
from cortex_tpu.ops import chains_mv as J
from cortex_tpu.ops import robust as jrobust
from cortex_tpu.ops import sqrt_kalman as jsqrt

SEQ_TOL, BLOCKED_TOL, ASSOC_TOL = 1e-5, 2e-4, 5e-4


def _random_system(rng, d, m):
    """tests/test_chains_mv.py's random stable system, float32."""
    A = 0.9 * np.linalg.qr(rng.normal(size=(d, d)))[0]
    Lq = rng.normal(size=(d, d)) * 0.3
    Q = Lq @ Lq.T + 0.1 * np.eye(d)
    H = rng.normal(size=(m, d))
    Lr = rng.normal(size=(m, m)) * 0.3
    R = Lr @ Lr.T + 0.2 * np.eye(m)
    m0 = rng.normal(size=d)
    P0 = np.eye(d) * 2.0
    return [a.astype(np.float32) for a in (A, Q, H, R, m0, P0)]


def numpy_rts_mv(y, A, Q, H, R, m0, P0):
    """Float64 Kalman filter + RTS smoother of one series ``y (T, m)``."""
    A, Q, H, R, m0, P0 = (np.asarray(a, np.float64) for a in (A, Q, H, R, m0, P0))
    T, d = y.shape[0], A.shape[0]
    fm, fP = np.zeros((T, d)), np.zeros((T, d, d))
    m, P_ = m0, P0
    for t in range(T):
        if t > 0:
            m, P_ = A @ m, A @ P_ @ A.T + Q
        S = H @ P_ @ H.T + R
        K = P_ @ H.T @ np.linalg.inv(S)
        m, P_ = m + K @ (y[t] - H @ m), P_ - K @ H @ P_
        fm[t], fP[t] = m, P_
    sm, sP = fm.copy(), fP.copy()
    for t in range(T - 2, -1, -1):
        Pp = A @ fP[t] @ A.T + Q
        G = fP[t] @ A.T @ np.linalg.inv(Pp)
        sm[t] = fm[t] + G @ (sm[t + 1] - A @ fm[t])
        sP[t] = fP[t] + G @ (sP[t + 1] - Pp) @ G.T
    return sm, sP


def _case(seed, d=3, m=2, T=10, R=3, gaps=True):
    rng = np.random.default_rng(seed)
    system = _random_system(rng, d, m)
    y = rng.normal(size=(R, T, m)).astype(np.float32)
    if gaps:
        y[1, 3, :] = np.nan  # a missing step mid-chain
        y[2, 0, :] = np.nan  # a missing first step
    return y, system


def _args(y, system, lib):
    A, Q, H, R, m0, P0 = system
    conv = torch.from_numpy if lib is torch else jnp.asarray
    return (conv(y), *map(conv, (A, Q, H, R)), (conv(m0), conv(P0)))


def _close(port, ref, atol, rtol=None):
    assert isinstance(port, torch.Tensor)
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    assert port.numpy().dtype == ref.dtype
    np.testing.assert_allclose(port.numpy(), ref, atol=atol, rtol=atol if rtol is None else rtol)


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


SMOOTHERS = {
    # name: (port, JAX, bar against JAX, bar against the float64 RTS)
    "scan": (P.mv_lgssm_smooth_seq, J.mv_lgssm_smooth_seq, SEQ_TOL, 5e-3),
    "blocked": (P.mv_lgssm_smooth_blocked, J.mv_lgssm_smooth_blocked, BLOCKED_TOL, 1e-4),
    "assoc": (P.mv_lgssm_smooth, J.mv_lgssm_smooth, ASSOC_TOL, 5e-3),
    "sqrt": (sqrt_lgssm_smooth, jsqrt.sqrt_lgssm_smooth, SEQ_TOL, 5e-3),
}


@pytest.mark.parametrize("name", list(SMOOTHERS))
def test_smoothers_match_jax_and_the_float64_rts(name):
    port, ref, tol, rts_tol = SMOOTHERS[name]
    y, system = _case(0, gaps=name != "sqrt")
    got = port(*_args(y, system, torch))
    want = _jit(ref)(*_args(y, system, jnp))
    assert got.mean.shape == (3, 10, 3) and got.cov.shape == (3, 10, 3, 3)
    _close(got.mean, want.mean, tol)
    _close(got.cov, want.cov, tol)
    sm, sP = numpy_rts_mv(y[0].astype(np.float64), *system)
    np.testing.assert_allclose(got.mean[0].numpy(), sm, rtol=rts_tol, atol=rts_tol)
    np.testing.assert_allclose(got.cov[0].numpy(), sP, rtol=rts_tol, atol=rts_tol)


@pytest.mark.parametrize("name", ["blocked", "assoc"])
def test_component_missing_matches_jax(name):
    port, ref, tol, _ = SMOOTHERS[name]
    y, system = _case(1, T=8)
    y[0, 2, 0] = y[2, 5, 1] = y[1, 0, 1] = np.nan  # partial steps, one the first
    got = port(*_args(y, system, torch), component_missing=True)
    want = _jit(ref, component_missing=True)(*_args(y, system, jnp))
    _close(got.mean, want.mean, tol)
    _close(got.cov, want.cov, tol)
    scan = P.mv_lgssm_smooth_seq(*_args(y, system, torch))  # always per component
    _close(got.mean, scan.mean.numpy(), tol)


def test_non_power_of_two_reverse_scan_order():
    """The reverse smoother combine on T = 7 (not a power of two: every
    Hillis–Steele round has a ragged edge), against JAX's and the scan."""
    y, system = _case(2, d=2, m=2, T=7, R=2, gaps=False)
    got = P.mv_lgssm_smooth(*_args(y, system, torch))
    want = _jit(J.mv_lgssm_smooth)(*_args(y, system, jnp))
    _close(got.mean, want.mean, ASSOC_TOL)
    _close(got.cov, want.cov, ASSOC_TOL)
    selems = P._SElem(*(torch.randn((7, 2) + s, generator=torch.Generator().manual_seed(3))
                        for s in ((2, 2), (2,), (2, 2))))
    jsel = J._SElem(*(jnp.asarray(a.numpy()) for a in selems))
    got = P._associative_scan(P._scombine, selems, reverse=True)
    want = jax.jit(lambda e: jax.lax.associative_scan(J._scombine, e, axis=0, reverse=True))(jsel)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("blocks", [1, 2, 5, 10, None])
def test_blocked_does_not_depend_on_the_block_split(blocks):
    y, system = _case(4, T=10, R=4)
    ref = P.mv_lgssm_smooth_seq(*_args(y, system, torch))
    out = P.mv_lgssm_smooth_blocked(*_args(y, system, torch), blocks=blocks)
    _close(out.mean, ref.mean.numpy(), BLOCKED_TOL)
    _close(out.cov, ref.cov.numpy(), BLOCKED_TOL)


def test_blocked_rejects_a_non_divisor_as_jax_does():
    y, eye = torch.zeros((10, 1)), torch.eye(1)
    with pytest.raises(ValueError, match="divide"):
        P.mv_lgssm_smooth_blocked(y, eye, eye, eye, eye, (torch.zeros(1), eye), blocks=3)


def test_pick_blocks_matches_jax():
    assert [P._pick_blocks(T) for T in range(1, 301)] == [J._pick_blocks(T) for T in
                                                           range(1, 301)]
    assert (P._pick_blocks(100), P._pick_blocks(256), P._pick_blocks(7)) == (10, 16, 1)


def test_paths_agree_on_random_shapes_and_gaps():
    """tests/test_chains_mv.py's fuzz: blocked and assoc against the scan over
    random d, m, T (T = 1, 2 and 3 included), replicas and missing steps."""
    rng = np.random.default_rng(99)
    for trial in range(10):
        d = int(rng.integers(1, 4))
        m = int(rng.integers(1, d + 1))
        T = int(rng.choice([1, 2, 3, 5, 8, 12]))
        R = int(rng.integers(1, 4))
        system = _random_system(rng, d, m)
        y = rng.normal(size=(R, T, m)).astype(np.float32)
        if T > 2 and trial % 2:
            for idx in rng.choice(T, size=int(rng.integers(1, T // 2 + 1)), replace=False):
                y[rng.integers(0, R), idx, :] = np.nan
        args = _args(y, system, torch)
        ref = P.mv_lgssm_smooth_seq(*args)
        for fn in (P.mv_lgssm_smooth_blocked, P.mv_lgssm_smooth):
            out = fn(*args)
            _close(out.mean, ref.mean.numpy(), ASSOC_TOL)
            _close(out.cov, ref.cov.numpy(), ASSOC_TOL)


def test_lane_major_algebra_matches_jax_and_the_batch_leading_layout():
    """The lane-major combines (leaves (..., d, d, R)) against the port's
    batch-leading ones (tests/test_chains_mv.py:282) and against JAX's lane
    helpers on the same elements, then the blocked scan's stages."""
    rng = np.random.default_rng(11)
    d, R = 3, 5

    def spd(scale, ridge):
        a = rng.normal(size=(R, d, d)) * scale
        return a @ np.swapaxes(a, -1, -2) + ridge * np.eye(d)

    def elem():
        return [rng.normal(size=(R, d, d)) * 0.4 + np.eye(d), rng.normal(size=(R, d)),
                spd(0.3, 0.5), rng.normal(size=(R, d)), spd(0.2, 0.1)]

    def selem():
        return [rng.normal(size=(R, d, d)) * 0.5, rng.normal(size=(R, d)), spd(0.3, 0.0)]

    def lanes(fields, kind, lib):
        conv = (lambda a: torch.from_numpy(a.astype(np.float32)).movedim(0, -1)) if lib is torch \
            else (lambda a: jnp.moveaxis(jnp.asarray(a, jnp.float32), 0, -1))
        return kind(*map(conv, fields))

    for combine, lcombine, jl, kind, jkind, make, tol in (
        (P._combine, P._lcombine, J._lcombine, P._Elem, J._Elem, elem, 1e-4),
        (P._scombine, P._lscombine, J._lscombine, P._SElem, J._SElem, selem, 1e-5),
    ):
        e1, e2 = make(), make()
        ref = combine(kind(*(torch.from_numpy(a.astype(np.float32)) for a in e1)),
                      kind(*(torch.from_numpy(a.astype(np.float32)) for a in e2)))
        lan = lcombine(lanes(e1, kind, torch), lanes(e2, kind, torch))
        want = jl(lanes(e1, jkind, jnp), lanes(e2, jkind, jnp))
        for f in kind._fields:
            _close(getattr(lan, f).movedim(-1, 0), getattr(ref, f).numpy(), tol)
            _close(getattr(lan, f), getattr(want, f), 1e-5)

    # The blocked scan's stages, lane-major, against JAX's on one model.
    y, system = _case(5, d=2, m=2, T=6, R=3)
    t_args, j_args = _args(y, system, torch), _args(y, system, jnp)
    for component in (False, True):
        elems, batch = P._build_filter_elems_lanes(*t_args[:5], *t_args[5],
                                                   component_missing=component)
        jelems = _jit(lambda *a, c=component: J._build_filter_elems_lanes(
            *a, component_missing=c)[0])(*j_args[:5], *j_args[5])
        assert batch == (3,)
        for g, w in zip(elems, jelems):
            _close(g, w, 1e-5)
    ident = P._lelem_identity((), 2, 3, torch.float32, "cpu")
    jident = J._lelem_identity((), 2, 3, jnp.float32)
    for g, w in zip(P._lseq_filter_total(elems, ident),
                    jax.jit(J._lseq_filter_total)(jelems, jident)):
        _close(g, w, 1e-4)
    fb, fC = P._lfilter_fillin(elems, ident.b, ident.C)
    jfb, jfC = jax.jit(J._lfilter_fillin)(jelems, jident.b, jident.C)
    _close(fb, jfb, 1e-5)
    _close(fC, jfC, 1e-5)
    selems = P._build_smoother_elems_lanes(fb, fC, *t_args[1:3])
    jselems = jax.jit(J._build_smoother_elems_lanes)(jfb, jfC, *j_args[1:3])
    sident = P._lselem_identity((), 2, 3, torch.float32, "cpu")
    jsident = J._lselem_identity((), 2, 3, jnp.float32)
    for g, w in zip(P._lseq_smoother_total(selems, sident),
                    jax.jit(J._lseq_smoother_total)(jselems, jsident)):
        _close(g, w, 1e-5)
    ms, Ps = P._lsmoother_fillin(selems, selems.g[-1], selems.L[-1])
    jms, jPs = jax.jit(J._lsmoother_fillin)(jselems, jselems.g[-1], jselems.L[-1])
    _close(ms, jms, 1e-5)
    _close(Ps, jPs, 1e-5)


@pytest.mark.parametrize("pivot", [True, False])
def test_solve_small_matches_numpy_and_jax(pivot):
    """tests/test_chains_mv.py:141-163's systems (2e-4), plus the pivotless
    form on diagonally dominant systems, d = 33 (the library fallback) and
    a zero leading pivot (pivoting only)."""
    rng = np.random.default_rng(0)
    for d in (1, 2, 4, 7, 16, 33):
        M = rng.normal(size=(5, 3, d, d))
        if not pivot:
            M = M + 2.0 * d * np.eye(d)
        B = rng.normal(size=(5, 3, d, d + 2))
        got = P._solve_small(torch.from_numpy(M), torch.from_numpy(B), pivot=pivot)
        np.testing.assert_allclose(got.numpy(), np.linalg.solve(M, B), rtol=2e-4, atol=2e-4)
        with jax.enable_x64(True):
            want = _jit(J._solve_small, pivot=pivot)(jnp.asarray(M), jnp.asarray(B))
        _close(got, want, 1e-10)
    if pivot:
        M, B = np.array([[[0.0, 1.0], [1.0, 2.0]]]), np.array([[[1.0], [0.0]]])
        got = P._solve_small(torch.from_numpy(M), torch.from_numpy(B))
        np.testing.assert_allclose(got.numpy(), np.linalg.solve(M, B), atol=1e-6)


@pytest.mark.parametrize("d", [1, 3, 16, 33])
def test_solve_small_logdet_matches_numpy_and_jax(d):
    rng = np.random.default_rng(d)
    a = rng.normal(size=(4, d, d)).astype(np.float32)
    M = a @ np.swapaxes(a, -1, -2) + d * np.eye(d, dtype=np.float32)
    B = rng.normal(size=(4, d, 2)).astype(np.float32)
    sol, logdet = P._solve_small_logdet(torch.from_numpy(M), torch.from_numpy(B))
    jsol, jlogdet = J._solve_small_logdet(jnp.asarray(M), jnp.asarray(B))
    _close(sol, jsol, 1e-5)
    _close(logdet, jlogdet, 1e-5)
    np.testing.assert_allclose(logdet.numpy(), np.linalg.slogdet(M.astype(np.float64))[1],
                               rtol=1e-5)


def test_mv_reduces_to_the_scalar_case():
    rng = np.random.default_rng(2)
    y = rng.normal(size=16).cumsum().astype(np.float32)
    t = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    result = P.mv_lgssm_smooth(torch.from_numpy(y[:, None]), t([[0.9]]), t([[0.5]]),
                               t([[1.0]]), t([[1.2]]), (t([0.0]), t([[3.0]])))
    scalar = ops.lgssm_smooth_scan(torch.from_numpy(y), A=0.9, Q=0.5, H=1.0, R=1.2,
                                   prior=(0.0, 3.0))
    _close(result.mean[:, 0], scalar.mean.numpy(), 1e-3)
    _close(result.cov[:, 0, 0], scalar.variance.numpy(), 1e-3)


def test_smoother_operator_and_matmul_match_jax():
    y, system = _case(6, d=3, m=2, T=8, gaps=False)
    t_args, j_args = _args(y, system, torch), _args(y, system, jnp)
    op = P.mv_lgssm_smoother_operator(8, *t_args[1:], device="cpu")
    jop = jax.jit(J.mv_lgssm_smoother_operator, static_argnums=0)(8, *j_args[1:])
    for g, w in zip(op, jop):
        _close(g, w, SEQ_TOL)
    got = P.mv_lgssm_smooth_matmul(t_args[0], operator=op)
    want = jax.jit(lambda v, o: J.mv_lgssm_smooth_matmul(v, operator=o))(j_args[0], jop)
    _close(got.mean, want.mean, SEQ_TOL)
    _close(got.cov, want.cov, SEQ_TOL)
    # tests/test_chains_mv.py:166: the operator reproduces the scan at 2e-5.
    scan = P.mv_lgssm_smooth_seq(*t_args)
    built = P.mv_lgssm_smooth_matmul(*t_args)
    for out in (got, built):
        _close(out.mean, scan.mean.numpy(), 2e-5)
        _close(out.cov, scan.cov.numpy(), 2e-5)
    carried = convert.mv_operator_from_numpy(tuple(map(np.asarray, jop)), device="cpu")
    _close(P.mv_lgssm_smooth_matmul(t_args[0], operator=carried).mean, want.mean, SEQ_TOL)
    with pytest.raises(ValueError, match="operator must be"):
        convert.mv_operator_from_numpy((jop.L, jop.c[:3], jop.cov), device="cpu")
    for fn in (P.mv_lgssm_smoother_operator, convert.mv_operator_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def _np_filter_ll(y, mask, A, Q, H, R, m0, P0):
    """tests/test_mv_filter_evidence.py's float64 filter and evidence."""
    A, Q, H, R, m0, P0 = (np.asarray(a, np.float64) for a in (A, Q, H, R, m0, P0))
    mean, P_ = m0.copy(), P0.copy()
    ll, means, covs = 0.0, [], []
    for t in range(y.shape[0]):
        if t > 0:
            mean, P_ = A @ mean, A @ P_ @ A.T + Q
        if mask[t]:
            S = H @ P_ @ H.T + R
            innov = y[t] - H @ mean
            ll += -0.5 * (innov @ np.linalg.solve(S, innov) + np.linalg.slogdet(2 * np.pi * S)[1])
            K = P_ @ H.T @ np.linalg.inv(S)
            mean, P_ = mean + K @ innov, P_ - K @ S @ K.T
        means.append(mean.copy())
        covs.append(P_.copy())
    return np.array(means), np.array(covs), ll


@pytest.mark.parametrize("dtype, tol", [(np.float32, SEQ_TOL), (np.float64, 1e-10)])
def test_filter_and_log_evidence_match_jax_and_the_oracle(dtype, tol):
    y, system = _case(7, d=3, m=2, T=12, R=2, gaps=False)
    y[0, [2, 3], :] = np.nan  # whole steps missing
    y[1, 5, 0] = np.nan  # one component missing
    y, system = y.astype(dtype), [a.astype(dtype) for a in system]
    with jax.enable_x64(dtype == np.float64):
        t_args, j_args = _args(y, system, torch), _args(y, system, jnp)
        got, want = P.mv_lgssm_filter(*t_args), _jit(J.mv_lgssm_filter)(*j_args)
        ev, jev = P.mv_lgssm_log_evidence(*t_args), _jit(J.mv_lgssm_log_evidence)(*j_args)
    _close(got.mean, want.mean, tol)
    _close(got.cov, want.cov, tol)
    _close(ev, jev, tol)
    mask = ~np.isnan(y[0]).any(-1)
    means, covs, ll = _np_filter_ll(np.nan_to_num(y[0]).astype(np.float64), mask, *system)
    np.testing.assert_allclose(got.mean[0].numpy(), means, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.cov[0].numpy(), covs, rtol=5e-3, atol=2e-3)
    assert float(ev[0]) == pytest.approx(ll, rel=1e-4)


def test_log_evidence_reduces_to_the_scalar_lgssm_and_drives_identification():
    rng = np.random.default_rng(3)
    y = rng.normal(size=(4, 16)).cumsum(axis=-1).astype(np.float32)
    a, q, h, r = 0.9, 0.4, 1.1, 0.6
    scalar = LGSSM(A=a, Q=q, H=h, R=r).log_evidence(torch.from_numpy(y), prior=(0.0, 1.0))
    vec = MvLGSSM.from_arrays([[a]], [[q]], [[h]], [[r]], [0.0], [[1.0]]).log_evidence(
        torch.from_numpy(y[..., None]))
    _close(vec, scalar.numpy(), 1e-4)
    # tests/test_mv_filter_evidence.py:91: the gradient brackets the true scale.
    A = np.array([[0.7, 0.2], [-0.1, 0.6]], np.float32)
    model = MvLGSSM.from_arrays(A, 0.3 * np.eye(2), np.eye(2), 0.5 * np.eye(2), np.zeros(2),
                                np.eye(2))
    _, ys = model.sample(torch.Generator().manual_seed(0), T=100, batch_shape=(8,))

    def grad(scale):
        s = torch.tensor(scale, requires_grad=True)
        nll = -torch.mean(P.mv_lgssm_log_evidence(
            ys, s * torch.from_numpy(A), 0.3 * torch.eye(2), torch.eye(2), 0.5 * torch.eye(2),
            (torch.zeros(2), torch.eye(2))))
        nll.backward()
        return float(s.grad)

    assert grad(0.6) < 0 < grad(1.4)


def test_sqrt_filter_matches_jax_in_both_factor_and_covariance():
    y, system = _case(8, d=3, m=2, T=10, gaps=True)
    got = sqrt_lgssm_filter(*_args(y, system, torch))
    want = _jit(jsqrt.sqrt_lgssm_filter)(*_args(y, system, jnp))
    _close(got.mean, want.mean, SEQ_TOL)
    _close(got.chol, want.chol, SEQ_TOL)
    cov = got.chol @ got.chol.transpose(-1, -2)
    _close(cov, np.asarray(want.chol @ jnp.swapaxes(want.chol, -1, -2)), SEQ_TOL)
    assert (torch.diagonal(got.chol, dim1=-2, dim2=-1) >= 0).all()
    torch.testing.assert_close(got.chol, torch.tril(got.chol), rtol=0, atol=0)


def test_sqrt_smoother_stays_psd_on_an_ill_conditioned_chain():
    """tests/test_sqrt_kalman.py:102: near-noiseless observations of a
    near-deterministic chain, a prior eleven orders of magnitude wider."""
    d = 4
    eye = torch.eye(d)
    y = torch.from_numpy(np.random.default_rng(7).normal(size=(200, d)).astype(np.float32) * 0.01)
    out = sqrt_lgssm_smooth(y, eye * 0.9999, eye * 1e-7, eye, eye * 1e-7,
                            (torch.zeros(d), eye * 1e4))
    var = torch.diagonal(out.cov, dim1=-2, dim2=-1)
    assert torch.isfinite(out.mean).all() and (var >= 0).all() and float(var.max()) < 1e-4


def _chain(T, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros(T)
    for t in range(1, T):
        x[t] = 0.95 * x[t - 1] + np.sqrt(0.3) * rng.normal()
    return x, (x + np.sqrt(0.4) * rng.normal(size=T)).astype(np.float32)


@pytest.mark.parametrize("nu, n_iters", [(4.0, 15), (1e7, 8)])
def test_robust_smoother_matches_jax(nu, n_iters):
    _, y = _chain(40, 1)
    Y = np.stack([y, y + 1.0, 2.0 * y])
    Y[0, 10] += 15.0  # an outlier
    Y[1, 20:23] = np.nan  # a gap
    kw = dict(A=0.95, Q=0.3, R=0.4, nu=nu, n_iters=n_iters, prior=(0.0, 5.0))
    got = robust_lgssm_smooth(torch.from_numpy(Y), **kw)
    want = jax.jit(lambda v: jrobust.robust_lgssm_smooth(v, **kw))(jnp.asarray(Y))
    for g, w in zip(got, want):
        _close(g, w, SEQ_TOL)
    if nu == 4.0:
        assert got.weights[0, 10] < 0.05  # the outlier is down-weighted
    else:  # tests/test_robust.py:22: nu -> infinity is the Gaussian smoother
        np.testing.assert_allclose(got.weights.numpy(), 1.0, atol=1e-3)
    np.testing.assert_allclose(got.weights[1, 20:23].numpy(), 1.0)


def test_robust_smoother_rejects_outliers():
    """tests/test_robust.py:33's case and bars."""
    x, y = _chain(120, 2)
    corrupt = [20, 55, 90]
    y[corrupt] += np.array([15.0, -20.0, 25.0], np.float32)
    yt = torch.from_numpy(y)
    gauss = ops.lgssm_smooth_scan(yt, A=0.95, Q=0.3, R=0.4, prior=(0.0, 5.0))
    robust = robust_lgssm_smooth(yt, A=0.95, Q=0.3, R=0.4, nu=4.0, prior=(0.0, 5.0))
    rmse = lambda m: float(np.sqrt(np.mean((m.numpy() - x) ** 2)))  # noqa: E731
    assert rmse(robust.mean) < 0.5 * rmse(gauss.mean)
    w = robust.weights.numpy()
    assert w[corrupt].max() < 0.05
    assert np.median(np.delete(w, corrupt)) > 0.7


# -- MvLGSSM -------------------------------------------------------------------------


def _models(seed=5, d=3, m=2):
    rng = np.random.default_rng(seed)
    arrays = _random_system(rng, d, m)
    return MvLGSSM.from_arrays(*arrays), jmodels.MvLGSSM.from_arrays(*arrays)


def test_from_arrays_and_convert_carry_the_jax_model_across():
    port, jax_model = _models()
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_model)
    assert convert.mv_lgssm_from_numpy(dataclasses.asdict(jax_model)) == port
    assert MvLGSSM(**dataclasses.asdict(jax_model)) == port
    with pytest.raises(ValueError, match="fields"):
        convert.mv_lgssm_from_numpy({**dataclasses.asdict(jax_model), "K": 2})
    assert port.dim == 3 and port.auto_method() == jax_model.auto_method() == "blocked"
    assert MvLGSSM.from_arrays(*[np.eye(9)] * 4, np.zeros(9), np.eye(9)).auto_method() == "scan"
    assert MvLGSSM.from_arrays(torch.eye(2), *[np.eye(2)] * 3, [0.0, 0.0], np.eye(2)) == \
        MvLGSSM.from_arrays(*[np.eye(2)] * 4, np.zeros(2), np.eye(2))


@pytest.mark.parametrize("method, missing, tol", [
    ("auto", "auto", BLOCKED_TOL), ("scan", "auto", SEQ_TOL), ("blocked", "step", BLOCKED_TOL),
    ("assoc", "step", ASSOC_TOL), ("matmul", "step", SEQ_TOL), ("sqrt", "step", SEQ_TOL),
    ("blocked", "component", BLOCKED_TOL), ("assoc", "auto", ASSOC_TOL),
])
def test_model_smooth_matches_jax_for_every_method(method, missing, tol):
    port, jax_model = _models()
    y = np.random.default_rng(6).normal(size=(2, 6, 2)).astype(np.float32)
    if method in ("blocked", "assoc", "scan", "auto") and missing != "step":
        y[0, 2, 1] = np.nan  # a partial step: "auto" resolves to "component"
    # JAX resolves "auto" on concrete input eagerly; under jit it would not,
    # so the resolved value is passed to the jitted call.
    resolved = missing
    if missing == "auto":
        resolved = "component" if jmodels.mv_lgssm._has_partial_missing(y) else "step"
    got = port.smooth(torch.from_numpy(y), method=method, missing=missing)
    want = jax.jit(lambda v: jax_model.smooth(v, method=method, missing=resolved))(
        jnp.asarray(y))
    _close(got.mean, want.mean, tol)
    _close(got.cov, want.cov, tol)


def test_model_filter_evidence_and_errors_match_jax():
    port, jax_model = _models()
    y = np.random.default_rng(7).normal(size=(2, 6, 2)).astype(np.float32)
    y[1, 3, 0] = np.nan
    yt = torch.from_numpy(y)
    _close(port.filter(yt).mean, jax.jit(jax_model.filter)(jnp.asarray(y)).mean, SEQ_TOL)
    _close(port.log_evidence(yt), jax.jit(jax_model.log_evidence)(jnp.asarray(y)), SEQ_TOL)
    for method, missing, match in (("bogus", "auto", "unknown method"),
                                   ("scan", "bogus", "unknown missing"),
                                   ("scan", "step", "per component"),
                                   ("matmul", "component", "dense data"),
                                   ("sqrt", "auto", "whole steps")):
        with pytest.raises(ValueError, match=match):
            port.smooth(yt, method=method, missing=missing)
    for method, missing in (("bogus", "auto"), ("scan", "bogus"), ("matmul", "component")):
        with pytest.raises(ValueError):
            jax_model.smooth(jnp.asarray(y), method=method, missing=missing)


def test_model_sample_shapes_statistics_and_round_trip():
    """tests/test_chains_mv.py:119: sample, smooth, and the smoothed states
    are closer to the truth than the observations."""
    model = MvLGSSM.from_arrays(0.9 * np.eye(2), 0.2 * np.eye(2), np.array([[1.0, 0.0]]),
                                [[0.5]], [0.0, 0.0], np.eye(2))
    x, y = model.sample(torch.Generator().manual_seed(0), T=16, batch_shape=(64,))
    assert x.shape == (64, 16, 2) and y.shape == (64, 16, 1) and x.dtype == torch.float32
    marg = model.smooth(y)
    assert marg.mean.shape == (64, 16, 2)
    assert (marg.mean[..., 0] - x[..., 0]).abs().mean() < (y[..., 0] - x[..., 0]).abs().mean()
    # Observation noise: y - H x has variance R = 0.5.
    assert float((y[..., 0] - x[..., 0]).var()) == pytest.approx(0.5, rel=0.1)
    x0, y0 = model.sample(torch.Generator().manual_seed(1), T=0, batch_shape=(3,))
    assert x0.shape == (3, 0, 2) and y0.shape == (3, 0, 1)


# -- fit_mv_lgssm_ml -------------------------------------------------------------------


@pytest.mark.parametrize("given", [False, True], ids=["default-init", "given-init"])
def test_fit_mv_lgssm_ml_matches_jax(given):
    d = 2
    rng = np.random.default_rng(8)
    y = rng.normal(size=(4, 12, d)).cumsum(axis=1).astype(np.float32)
    init = jinit = None
    if given:
        A = np.array([[0.9, 0.1], [0.0, 0.8]], np.float32)
        init = MvLGSSMParams(torch.from_numpy(A), torch.zeros(d, d), torch.zeros(d, d))
        jinit = jfit.MvLGSSMParams(jnp.asarray(A), jnp.zeros((d, d)), jnp.zeros((d, d)))
    params, losses = fit_mv_lgssm_ml(torch.from_numpy(y), H=np.eye(d), d=d, n_steps=8,
                                     init=init)
    want, want_losses = jfit.fit_mv_lgssm_ml(jnp.asarray(y), H=np.eye(d), d=d, n_steps=8,
                                             init=jinit)
    assert losses.shape == (8,) and float(losses[-1]) < float(losses[0])
    _close(losses, want_losses, 1e-4)
    for name in ("A", "q_chol", "r_chol", "Q", "R"):
        _close(getattr(params, name), getattr(want, name), 1e-4)


def test_fit_mv_lgssm_ml_with_zero_steps_returns_the_initial_params():
    y = torch.zeros(2, 5, 2)
    params, losses = fit_mv_lgssm_ml(y, H=np.eye(2), d=2, n_steps=0)
    assert losses.shape == (0,) and losses.dtype == torch.float32
    torch.testing.assert_close(params.A, 0.5 * torch.eye(2))
    torch.testing.assert_close(params.Q, torch.eye(2))
    assert not any(p.requires_grad for p in params)


def test_mv_entry_points_follow_their_input():
    y, system = _case(9, T=4, gaps=False)
    out = P.mv_lgssm_smooth_seq(torch.from_numpy(y).double(), *system[:4], tuple(system[4:]))
    assert out.mean.dtype == torch.float64 and out.mean.device.type == "cpu"
    assert math.isfinite(float(out.cov.sum()))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_mv_main_path_rehearses_on_cpu():
    """chip_smoke's vector-chain phase at a small size on the CPU: every
    method against the float64 RTS, the filter and evidence against the
    float64 filter, gaps, the robust smoother and the ML fit."""
    checks = _chip_smoke().run_mv_main_path(torch, models, ops, "cpu", shapes=((2, 8), (3, 4)),
                                            T=20, n_ref=4, robust=(16, 20), fit_R=8, fit_steps=2)
    assert len(checks) == 20
    assert {c["path"] for c in checks} >= {"smooth auto (blocked)", "robust_lgssm_smooth",
                                           "fit_mv_lgssm_ml"}


def test_chip_smoke_numpy_kalman_matches_the_oracle_of_the_jax_tests():
    smoke = _chip_smoke()
    y, system = _case(10, d=2, m=2, T=9, R=2, gaps=False)
    fm, fP, ll, sm, sP = smoke.numpy_kalman_mv(y, *system)
    for b in range(2):
        want_sm, want_sP = numpy_rts_mv(y[b].astype(np.float64), *system)
        np.testing.assert_allclose(sm[b], want_sm, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(sP, want_sP, rtol=1e-10, atol=1e-10)
        means, covs, want_ll = _np_filter_ll(y[b].astype(np.float64), np.ones(9, bool), *system)
        np.testing.assert_allclose(fm[b], means, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(fP, covs, rtol=1e-10, atol=1e-10)
        assert ll[b] == pytest.approx(want_ll, rel=1e-10)
