"""Port parity: loopy Gaussian BP (``cortex_tpu_torch.ops.gabp``) and HMC
(``ops.hmc``) against the JAX package, and their sharded runs in a gloo world.

The same numpy inputs go through both packages on the CPU (JAX under
``jax.jit``).  Bars, those of tests/test_gabp.py, tests/test_hmc.py and
tests/test_parallel.py:

- GaBP on a tree against the dense solve and JAX: rtol 1e-4, atol 1e-5 (means
  and variances); on a loopy grid: rtol 2e-4, atol 2e-5 (means); the grid
  stencil against the edge list: the same; batched replicas against single
  ones: rtol 1e-5, atol 1e-6.  The scatter-add's float order may differ from
  JAX's, so results agree to rounding, not bit for bit.
- HMC draws its randomness from a ``torch.Generator``, which JAX's keys cannot
  reproduce: it is held to the targets of tests/test_hmc.py at its bars
  (correlated Gaussian: mean 0.08, covariance 0.25, acceptance in (0.6, 1];
  the Beta-Bernoulli posterior: mean 0.015, variance rel 0.3; tree positions:
  mean 0.2), over a chain axis in place of JAX's vmap over keys.  Its
  trajectories are shorter and its chains more than JAX's (as many draws or
  more): a step costs ~0.8 ms of torch.func dispatch on the CPU.
- Sharded, in one gloo world of 4 CPU ranks (chip_smoke.run_parallel_ranks,
  body ``zoo_sharded_rank``): each rank's block of replica-sharded GaBP grids
  equals the single-device run (1e-5, tests/test_parallel.py's bar) and JAX's;
  the chains sharded over the ranks, pooled by ``gather``, hold their moments
  within chip_smoke.check_hmc's Monte-Carlo bars.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cortex_tpu_torch import ops

import cortex_tpu.ops as jops
from cortex_tpu.ops import gabp as jgabp

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
WORLD_SHAPES = {"gabp": [64, 8, 8, 60], "hmc": [8, 3, 40, 60, 8]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them:
    an HMC test took 30 s under load against 4 s with one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, want, rtol, atol=0.0):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def _dense(lam_diag, edges, lam_off, eta):
    L = np.diag(np.asarray(lam_diag, np.float64))
    for (i, j), v in zip(np.asarray(edges), np.asarray(lam_off)):
        L[i, j] += v
        L[j, i] += v
    S = np.linalg.inv(L)
    return np.asarray(eta, np.float64) @ S, np.diag(S)


def test_grid_edges_equal_jax():
    assert np.array_equal(ops.grid_edges(3, 4), jgabp.grid_edges(3, 4))


@pytest.mark.parametrize("case", ["tree", "loopy grid"])
def test_gabp_solve_matches_the_dense_solve_and_jax(case):
    rng = np.random.default_rng(0)
    if case == "tree":  # a path: exact in means and variances
        n = 12
        lam_diag = (2.0 + rng.random(n)).astype(np.float32)
        edges = np.array([[i, i + 1] for i in range(n - 1)])
        lam_off = (-0.5 + 0.2 * rng.random(n - 1)).astype(np.float32)
        kw, rtol, atol = dict(n_iters=80, damping=1.0), 1e-4, 1e-5
    else:
        n = 6 * 7
        edges = jgabp.grid_edges(6, 7)
        lam_diag = np.full(n, 5.0, np.float32)
        lam_off = (-1.0 + 0.2 * rng.random(len(edges))).astype(np.float32)
        kw, rtol, atol = dict(n_iters=120), 2e-4, 2e-5
    eta = rng.normal(size=(2, n)).astype(np.float32)
    got = ops.gabp_solve(torch.from_numpy(lam_diag), torch.from_numpy(eta), edges,
                         torch.from_numpy(lam_off), **kw)
    want = jax.jit(lambda *a: jops.gabp_solve(*a, **kw))(lam_diag, eta, edges, lam_off)
    mean_d, var_d = _dense(lam_diag, edges, lam_off, eta)
    _close(got.mean, want.mean, rtol, atol)
    _close(got.mean, mean_d, rtol, atol)
    if case == "tree":
        _close(got.variance, var_d, rtol, atol)
        assert float(got.delta) < 1e-6
    else:  # loopy variances are approximate, positive under-estimates
        assert torch.all(got.variance > 0)
        assert float(torch.max(torch.abs(got.variance - torch.from_numpy(var_d)) / var_d)) < 0.3
    _close(got.variance, want.variance, rtol, atol)


def test_gabp_batched_replicas_match_single_ones():
    edges = ops.grid_edges(4, 4)
    lam_diag = torch.full((16,), 4.0)
    lam_off = torch.full((len(edges),), -0.8)
    etas = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 16)).astype(np.float32))
    batched = ops.gabp_solve(lam_diag, etas, edges, lam_off, n_iters=100)
    single = ops.gabp_solve(lam_diag, etas[3], edges, lam_off, n_iters=100)
    assert batched.mean.shape == (5, 16) and batched.variance.shape == (16,)
    _close(batched.mean[3], single.mean.numpy(), rtol=1e-5, atol=1e-6)
    _close(batched.variance, single.variance.numpy(), rtol=1e-5)


@pytest.mark.parametrize("iters, damping", [(7, 0.7), (60, 1.0)])
def test_gabp_grid_stencil_matches_the_edge_list_and_jax(iters, damping):
    h, w = 5, 9
    rng = np.random.default_rng(4)
    edges = ops.grid_edges(h, w)
    lam_diag = (4.0 + rng.random((h, w))).astype(np.float32)
    eta = rng.normal(size=(3, h, w)).astype(np.float32)
    grid = ops.gabp_grid_solve(torch.from_numpy(lam_diag), torch.from_numpy(eta), -0.9,
                               n_iters=iters, damping=damping)
    flat = ops.gabp_solve(torch.from_numpy(lam_diag).reshape(-1),
                          torch.from_numpy(eta).reshape(3, -1), edges,
                          torch.full((len(edges),), -0.9), n_iters=iters, damping=damping)
    _close(grid.mean.reshape(3, -1), flat.mean.numpy(), rtol=2e-4, atol=2e-5)
    _close(grid.variance.reshape(-1), flat.variance.numpy(), rtol=2e-4, atol=2e-5)
    want = jax.jit(lambda l, e: jgabp.gabp_grid_solve(l, e, -0.9, n_iters=iters,
                                                      damping=damping))(lam_diag, eta)
    for got, ref in zip(grid, want):
        _close(got, ref, rtol=2e-4, atol=2e-5)


def test_hmc_correlated_gaussian_moments_over_a_chain_axis():
    cov = torch.tensor([[2.0, 1.2], [1.2, 1.0]])
    prec, mean = torch.linalg.inv(cov), torch.tensor([1.0, -2.0])

    def logp(x):
        d = x - mean
        return -0.5 * d @ prec @ d

    res = ops.hmc_sample(torch.Generator().manual_seed(0), logp, torch.zeros(128, 2),
                         n_samples=100, n_warmup=60, n_leapfrog=8, n_chains=128)
    assert res.samples.shape == (128, 100, 2) and res.log_density.shape == (128, 100)
    assert res.accept_rate.shape == (128,) and res.step_size.shape == (128,)
    draws = res.samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(axis=0), mean.numpy(), atol=0.08)
    np.testing.assert_allclose(np.cov(draws.T), cov.numpy(), atol=0.25)
    assert 0.6 < float(res.accept_rate.mean()) <= 1.0
    # Each chain adapts its own step size, as JAX's vmap over keys gives.
    assert len(set(res.step_size.tolist())) > 1
    _close(res.log_density, torch.vmap(logp)(res.samples.reshape(-1, 2)).reshape(128, 100),
           rtol=1e-5, atol=1e-5)


def test_hmc_beta_bernoulli_logit_matches_the_conjugate_posterior():
    y = torch.from_numpy((np.random.default_rng(0).random(50) < 0.7).astype(np.float32))
    h, t = float(y.sum()), float((1 - y).sum())

    def logp(logit):
        lp = torch.nn.functional.logsigmoid(logit)
        lq = torch.nn.functional.logsigmoid(-logit)
        return torch.sum(y * lp + (1 - y) * lq) + lp + lq

    res = ops.hmc_sample(torch.Generator().manual_seed(1), logp, torch.zeros(128),
                         n_samples=100, n_warmup=100, n_leapfrog=8, n_chains=128)
    p = torch.sigmoid(res.samples).reshape(-1).numpy()
    a, b = 1 + h, 1 + t
    assert p.mean() == pytest.approx(a / (a + b), abs=0.015)
    assert p.var() == pytest.approx(a * b / ((a + b) ** 2 * (a + b + 1)), rel=0.3)


def test_hmc_tree_positions_with_and_without_a_chain_axis():
    def logp(tree):
        return -0.5 * torch.sum(tree["a"] ** 2) - 0.5 * torch.sum((tree["b"] - 3.0) ** 2)

    res = ops.hmc_sample(torch.Generator().manual_seed(1), logp,
                         {"a": np.zeros((2, 2)), "b": np.zeros(3)}, n_samples=150, n_warmup=60,
                         n_leapfrog=8)
    assert res.samples["a"].shape == (150, 2, 2) and res.samples["b"].shape == (150, 3)
    assert res.samples["a"].dtype == torch.float32  # numpy leaves as jnp.asarray makes them
    assert float(res.samples["b"].mean()) == pytest.approx(3.0, abs=0.2)
    assert res.step_size.shape == () and float(res.step_size) > 0
    chains = ops.hmc_sample(torch.Generator().manual_seed(2), logp,
                            {"a": torch.zeros(3, 2, 2), "b": torch.zeros(3, 3)},
                            n_samples=20, n_warmup=20, n_leapfrog=4, n_chains=3)
    assert chains.samples["a"].shape == (3, 20, 2, 2) and chains.samples["b"].shape == (3, 20, 3)
    with pytest.raises(ValueError, match="chain axis"):
        ops.hmc_sample(torch.Generator(), logp, {"a": torch.zeros(2, 2), "b": torch.zeros(3)},
                       n_samples=5, n_warmup=5, n_chains=3)


def test_hmc_draws_follow_the_generator():
    def logp(x):
        return -0.5 * torch.sum(x**2)

    runs = [ops.hmc_sample(torch.Generator().manual_seed(s), logp, torch.zeros(2, 3),
                           n_samples=20, n_warmup=20, n_leapfrog=4, n_chains=2)
            for s in (5, 5, 6)]
    assert torch.equal(runs[0].samples, runs[1].samples)
    assert not torch.equal(runs[0].samples, runs[2].samples)


def test_sharded_gabp_and_hmc_in_a_gloo_world(tmp_path):
    """One world of 4 CPU ranks for both bodies: each rank's GaBP block equals
    the single-device run and JAX's, the chains pooled over the ranks hold
    their moments (the body raises otherwise)."""
    ranks = _chip_smoke().run_parallel_ranks("zoo_sharded_rank", WORLD, tmp_path,
                                             shapes=WORLD_SHAPES)
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert {c["path"] for c in ranks[0]["checks"]} == {"replica-sharded gabp_grid_solve",
                                                       "chain-sharded HMC"}
    blocks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    eta = torch.cat([b["gabp eta"] for b in blocks]).numpy()
    lam = blocks[0]["gabp lam"].numpy()
    R, H, W, n_iters = WORLD_SHAPES["gabp"]
    assert eta.shape == (R, H, W)
    want = jax.jit(lambda l, e: jgabp.gabp_grid_solve(l, e, -0.8, n_iters=n_iters))(lam, eta)
    _close(torch.cat([b["gabp mean"] for b in blocks]), want.mean, rtol=1e-5, atol=1e-6)
    C, d, _, n_samples, _ = WORLD_SHAPES["hmc"]
    samples = [b["hmc samples"] for b in blocks]
    assert all(s.shape == (C // WORLD, n_samples, d) for s in samples)
    assert not torch.equal(samples[0], samples[1])  # each rank draws its own chains
    hmc = next(c for c in ranks[0]["checks"] if c["path"] == "chain-sharded HMC")
    assert hmc["chains"] == C and max(hmc["worst_share_of_bar"]) <= 1.0
