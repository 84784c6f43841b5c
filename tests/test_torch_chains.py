"""Port parity: cortex_tpu_torch.ops.chains against cortex_tpu.ops.chains.

The same numpy inputs, made from a seed, go through the JAX function and its
PyTorch counterpart on the CPU, both in float32.  Tolerances: 1e-5 where both
sides run the same float32 recursion; 2e-4 for the matmul form, the bar of
tests/test_lgssm.py; 1e-3 for the associative scan, whose combine order
differs between the two scans (tests/test_lgssm.py's bar for assoc).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cortex_tpu_torch.convert import operator_from_numpy, prior_from_numpy
from cortex_tpu_torch.ops import chains as tc

from cortex_tpu.ops import chains as jc

PARAMS = [dict(), dict(A=0.9, Q=0.5, H=2.0, R=0.3)]
# One shape for every JAX call: JAX compiles each function once per shape.
SHAPE = (6, 40)


def _walk(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).cumsum(axis=-1).astype(np.float32)


def _with_gaps(y, seed, frac=0.15):
    """Copy of ``y`` with NaN gaps, none at t = 0."""
    rng = np.random.default_rng(seed)
    gaps = rng.random(y.shape) < frac
    gaps[..., 0] = False
    return np.where(gaps, np.float32(np.nan), y)


def assert_marginals(port, ref, tol):
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(ref.mean), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        port.variance.numpy(), np.asarray(ref.variance), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("prior", [None, (1.5, 4.0)])
def test_scan_matches_jax(params, prior):
    y = _walk(0, SHAPE)
    port = tc.lgssm_smooth_scan(torch.from_numpy(y), **params, prior=prior)
    ref = jc.lgssm_smooth_scan(jnp.asarray(y), **params, prior=prior)
    assert_marginals(port, ref, 1e-5)


@pytest.mark.parametrize("prior", [None, (0.5, 2.0)])
def test_scan_with_nan_gaps_matches_jax(prior):
    y = _with_gaps(_walk(1, SHAPE), seed=2)
    y[3, 10:30] = np.nan  # a long run of missing steps
    port = tc.lgssm_smooth_scan(torch.from_numpy(y), 0.95, 0.4, 1.0, 1.2, prior)
    ref = jc.lgssm_smooth_scan(jnp.asarray(y), 0.95, 0.4, 1.0, 1.2, prior)
    assert np.isfinite(port.mean.numpy()).all()
    assert_marginals(port, ref, 1e-5)


def test_scan_batch_prior_and_unbatched_chain():
    y = _walk(3, SHAPE)
    pm = np.linspace(-1.0, 1.0, SHAPE[0]).astype(np.float32)
    pv = np.linspace(0.5, 2.0, SHAPE[0]).astype(np.float32)
    prior = prior_from_numpy((pm, pv), device="cpu")
    port = tc.lgssm_smooth_scan(torch.from_numpy(y), prior=prior)
    ref = jc.lgssm_smooth_scan(jnp.asarray(y), prior=(jnp.asarray(pm), jnp.asarray(pv)))
    assert_marginals(port, ref, 1e-5)
    one = tc.lgssm_smooth_scan(torch.from_numpy(y[0]))
    assert_marginals(one, jc.lgssm_smooth_scan(jnp.asarray(y[0])), 1e-5)


@pytest.mark.parametrize("params", PARAMS)
def test_operator_matches_jax(params):
    port = tc.lgssm_smoother_operator(SHAPE[1], **params, prior=(0.3, 2.0), device="cpu")
    ref = jc.lgssm_smoother_operator(SHAPE[1], **params, prior=(0.3, 2.0))
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("prior", [None, (1.5, 4.0)])
def test_matmul_matches_jax(params, prior):
    y = _walk(4, SHAPE)
    port = tc.lgssm_smooth_matmul(torch.from_numpy(y), **params, prior=prior)
    ref = jc.lgssm_smooth_matmul(jnp.asarray(y), **params, prior=prior)
    assert_marginals(port, ref, 2e-4)


def test_matmul_with_precomputed_operator():
    y = _walk(9, SHAPE)
    A, Q, H, R = 0.95, 0.8, 1.2, 0.5
    ref = jc.lgssm_smooth_scan(jnp.asarray(y), A, Q, H, R)
    own = tc.lgssm_smoother_operator(40, A, Q, H, R, device="cpu")
    carried = operator_from_numpy(
        [np.asarray(a) for a in jc.lgssm_smoother_operator(40, A, Q, H, R)], device="cpu"
    )
    for op in (own, carried):
        out = tc.lgssm_smooth_matmul(torch.from_numpy(y), operator=op)
        assert_marginals(out, ref, 2e-4)


def test_matmul_leaves_matmul_precision_as_it_was():
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        tc.lgssm_smooth_matmul(torch.from_numpy(_walk(5, (2, 8))))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(previous)


def test_messages_scan_matches_jax():
    y = _walk(6, SHAPE)
    y[1, 4] = np.nan
    port = tc.lgssm_messages_scan(torch.from_numpy(y), 0.9, 0.5, 2.0, 0.7)
    ref = jc.lgssm_messages_scan(jnp.asarray(y), 0.9, 0.5, 2.0, 0.7)
    assert port.keys() == ref.keys()
    for key in ref:
        for p, r in zip(port[key], ref[key]):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_scalar_kalman_update_matches_jax():
    rng = np.random.default_rng(7)
    obs, m, v = (rng.normal(size=50).astype(np.float32) for _ in range(3))
    v = np.abs(v) + np.float32(0.1)
    port = tc.scalar_kalman_update(*map(torch.from_numpy, (obs, m, v)), 1.3, 0.6)
    ref = jc.scalar_kalman_update(*map(jnp.asarray, (obs, m, v)), 1.3, 0.6)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("prior", [None, (1.5, 4.0)])
@pytest.mark.parametrize("gaps", [False, True])
def test_assoc_matches_jax(params, prior, gaps):
    y = _walk(8, SHAPE)
    if gaps:
        y = _with_gaps(y, seed=9)
    port = tc.lgssm_smooth_assoc(torch.from_numpy(y), **params, prior=prior)
    ref = jc.lgssm_smooth_assoc(jnp.asarray(y), **params, prior=prior)
    assert_marginals(port, ref, 1e-3)
    assert_marginals(port, jc.lgssm_smooth_scan(jnp.asarray(y), **params, prior=prior), 1e-3)


@pytest.mark.parametrize("T", [1, 2, 5, 8, 13])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_sequential_fold(T, reverse):
    """The log-depth scan against a left fold of a non-commutative operator:
    composition of affine maps x -> a x + b, held as (a, b)."""

    class Affine(tuple):
        def __new__(cls, a, b):
            return super().__new__(cls, (a, b))

    def compose(first, then):
        return Affine(then[0] * first[0], then[0] * first[1] + then[1])

    rng = np.random.default_rng(T)
    a = torch.from_numpy(rng.normal(size=(T, 3)))
    b = torch.from_numpy(rng.normal(size=(T, 3)))
    out = tc._associative_scan(compose, Affine(a, b), reverse=reverse)
    steps = range(T - 1, -1, -1) if reverse else range(T)
    acc = None
    for t in steps:
        acc = Affine(a[t], b[t]) if acc is None else compose(acc, Affine(a[t], b[t]))
        torch.testing.assert_close(out[0][t], acc[0], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(out[1][t], acc[1], rtol=1e-12, atol=1e-12)
