"""Port parity: ``cortex_tpu_torch.diag`` against ``cortex_tpu.diag``.

The cases of ``tests/test_diag_tracing.py`` (but the compiled path's tracing,
which ``tests/test_torch_compile.py`` covers) run on the port, each held to
the JAX function on the same numpy inputs: ``check_finite``'s message names
the same leaves by the same paths, ``ConvergenceMonitor`` flags the same
replicas, and ``rhat`` and ``ess`` agree within rtol 1e-5 (float32 inputs:
the two FFT libraries round differently).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cortex_tpu_torch import diag
from cortex_tpu_torch.models.hgf import HGF
from cortex_tpu_torch.ops import hmc_sample

from cortex_tpu import diag as jdiag
from cortex_tpu.models.hgf import HGF as JaxHGF

DIAG_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _message(check, tree):
    with pytest.raises(Exception) as info:
        check(tree, where="posterior")
    return info


def test_check_finite_passes_clean_tree():
    diag.check_finite({"a": torch.ones(3), "b": (torch.zeros(2), torch.tensor(1.0))})


def test_check_finite_names_bad_leaves():
    bad = np.array([1.0, np.nan, np.inf], dtype=np.float32)
    got = _message(diag.check_finite, {"good": torch.ones(3), "bad": torch.from_numpy(bad)})
    want = _message(jdiag.check_finite, {"good": jnp.ones(3), "bad": jnp.asarray(bad)})
    assert got.type is diag.DivergenceError
    assert str(got.value) == str(want.value)
    assert "['bad'] (2 non-finite)" in str(got.value)


def test_check_finite_names_named_tuple_fields_and_sequence_items():
    """Leaves of a named tuple are named by field, of a list by index, as
    JAX's keystr writes them."""
    state = HGF().init_state((2,), device="cpu")
    jstate = JaxHGF().init_state((2,))
    tree = [state._replace(pi2=torch.tensor([1.0, np.nan])), torch.tensor(np.inf)]
    jtree = [jstate._replace(pi2=jnp.asarray([1.0, np.nan])), jnp.asarray(np.inf)]
    got, want = _message(diag.check_finite, tree), _message(jdiag.check_finite, jtree)
    assert str(got.value) == str(want.value)
    assert "[0].pi2 (1 non-finite)" in str(got.value) and "[1] (1 non-finite)" in str(got.value)


def _monitor_flags(module, fes, **kwargs):
    monitor = module.ConvergenceMonitor(**kwargs)
    flags = [np.asarray(monitor.update(np.asarray(fe))) for fe in fes]
    return monitor, flags


def test_convergence_monitor_detects_convergence():
    fes = [100.0, 50.0, 40.0, 39.99, 39.9899]
    m, flags = _monitor_flags(diag, fes, rtol=1e-3)
    _, jflags = _monitor_flags(jdiag, fes, rtol=1e-3)
    assert [bool(f) for f in flags] == [bool(f) for f in jflags]
    assert not flags[1] and not flags[2]
    assert flags[4]
    assert not m.diverged


def test_convergence_monitor_detects_divergence():
    m, _ = _monitor_flags(diag, [10.0, 11.0, 12.0, 13.0], patience=2)
    assert m.diverged
    with pytest.raises(diag.DivergenceError):
        m.raise_if_diverged()


def test_convergence_monitor_vectorized_over_replicas():
    """Tensors (one value a replica) go to the host as JAX's arrays do."""
    fes = [torch.tensor([10.0, 10.0]), torch.tensor([9.0, 11.0]), torch.tensor([8.5, 12.0])]
    m, _ = _monitor_flags(diag, fes, patience=2)
    jm, _ = _monitor_flags(jdiag, [f.numpy() for f in fes], patience=2)
    d = m.diverged
    assert not d[0] and d[1]
    np.testing.assert_array_equal(d, jm.diverged)


def test_convergence_monitor_nan_is_divergence():
    m, _ = _monitor_flags(diag, [np.asarray([np.nan])])
    assert m.diverged.all()


def _ar1(rng, m, n, phi):
    z = np.zeros((m, n))
    eps = rng.normal(size=(m, n))
    for t in range(1, n):
        z[:, t] = phi * z[:, t - 1] + eps[:, t]
    return z.astype(np.float32)


def test_rhat_mixed_vs_stuck_chains():
    rng = np.random.default_rng(0)
    mixed = rng.normal(size=(4, 500)).astype(np.float32)
    stuck = mixed + np.arange(4.0, dtype=np.float32)[:, None]
    vec = rng.normal(size=(4, 300, 3)).astype(np.float32)
    for x in (mixed, stuck, vec):
        np.testing.assert_allclose(diag.rhat(torch.from_numpy(x)).numpy(),
                                   np.asarray(jdiag.rhat(jnp.asarray(x))), rtol=DIAG_RTOL)
    r = float(diag.rhat(torch.from_numpy(mixed)))
    assert 0.99 < r < 1.02, r
    assert float(diag.rhat(torch.from_numpy(stuck))) > 1.5
    assert diag.rhat(torch.from_numpy(vec)).shape == (3,)


def test_ess_iid_and_ar1():
    rng = np.random.default_rng(1)
    m, n = 4, 2000
    iid = rng.normal(size=(m, n)).astype(np.float32)
    e = float(diag.ess(torch.from_numpy(iid)))
    np.testing.assert_allclose(e, float(jdiag.ess(jnp.asarray(iid))), rtol=DIAG_RTOL)
    assert 0.7 * m * n < e <= 1.3 * m * n, e

    phi = 0.9
    z = _ar1(rng, m, n, phi)
    expected = m * n * (1 - phi) / (1 + phi)
    e_ar = float(diag.ess(torch.from_numpy(z)))
    np.testing.assert_allclose(e_ar, float(jdiag.ess(jnp.asarray(z))), rtol=DIAG_RTOL)
    assert 0.5 * expected < e_ar < 2.0 * expected, (e_ar, expected)
    assert e_ar < 0.2 * m * n
    # float64 draws stay float64, as the chip run computes them.
    assert diag.ess(torch.from_numpy(z).double()).dtype == torch.float64


def test_ess_rhat_on_hmc_output():
    """Four chains of the port's HMC on a standard normal (8 leapfrog steps,
    not the default 32, for time): JAX's bars, and JAX's rhat and ess of the
    same draws."""
    gen = torch.Generator().manual_seed(2)
    res = hmc_sample(gen, lambda x: -0.5 * torch.sum(x**2), torch.zeros(4, 2),
                     n_samples=300, n_warmup=200, n_leapfrog=8, n_chains=4)
    draws0 = res.samples[..., 0]  # (4, 300)
    assert float(diag.rhat(draws0)) < 1.05
    assert float(diag.ess(draws0)) > 200.0
    np.testing.assert_allclose(float(diag.rhat(draws0)),
                               float(jdiag.rhat(jnp.asarray(draws0.numpy()))), rtol=DIAG_RTOL)
    np.testing.assert_allclose(float(diag.ess(draws0)),
                               float(jdiag.ess(jnp.asarray(draws0.numpy()))), rtol=DIAG_RTOL)
