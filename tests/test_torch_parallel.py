"""Port parity: the parallel layer (``cortex_tpu_torch.parallel``) on
``torch.distributed`` against the JAX package's meshes.

One world of 4 CPU ranks joined by gloo runs every entry point
(``chip_smoke.parallel_parity_rank``) on inputs this module writes, and saves
each rank's blocks; the tests join the blocks and hold them against the JAX
functions on a 4-device mesh of conftest's 8 virtual CPU devices, so both
fold the same number of blocks.  A second world rehearses chip_smoke's
parallel main path at a small size.  Each world runs in fresh processes
that import torch only, with a 60 s collective timeout and a time limit of
its own.  Bars: the JAX tests' own (tests/test_parallel.py, tests/test_hgf.py):
replica-sharded 1e-5, time-sharded scalar and replica x time 1e-3, pipelined
1e-4, vector time-sharded 2e-3 (covariances 5e-3 with missing components),
the Beta-Bernoulli closed form 1e-6, SLDS 1e-5, HGF streaming 1e-5.
"""

import functools
import importlib.util
import time
from pathlib import Path

from datetime import timedelta
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cortex_tpu_torch import parallel

import cortex_tpu.models as jmodels
import cortex_tpu.parallel as jparallel
from cortex_tpu.ops import lgssm_smooth_scan
from cortex_tpu.ops.chains_mv import mv_lgssm_smooth


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them,
    8-20x slower on small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
WORLD_TIMEOUT = 120.0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _inputs():
    """The inputs of tests/test_parallel.py's cases, from their seeds."""
    walk = {seed: np.random.default_rng(seed) for seed in range(8)}
    d = {
        "replica_y": walk[0].normal(size=(64, 32)).cumsum(axis=-1),
        "psum_y": walk[1].normal(size=(32, 16)),
        "time_y": walk[2].normal(size=(4, 64)).cumsum(axis=-1),
        "combined_y": walk[3].normal(size=(8, 32)).cumsum(axis=-1),
        "pipe_y": walk[4].normal(size=(16, 64)).cumsum(axis=-1),
        "bernoulli": (walk[5].random((12, 64)) < 0.4),
        "hgf_u": np.random.default_rng(6).normal(size=(64, 50)),
    }
    y = walk[6].normal(size=(8, 32)).cumsum(axis=-1)
    y[0, 5:9] = np.nan
    y[3, 0] = np.nan
    d["pipe_nan_y"] = y

    rng = np.random.default_rng(7)
    dim = 2
    d.update(mv_A=0.9 * np.eye(dim), mv_Q=0.3 * np.eye(dim), mv_H=rng.normal(size=(1, dim)),
             mv_R=0.4 * np.eye(1), mv_m0=np.zeros(dim), mv_P0=2.0 * np.eye(dim),
             mv_y=rng.normal(size=(3, 40, 1)))
    rng = np.random.default_rng(17)
    y = rng.normal(size=(3, 40, 2)).cumsum(1)
    y[0, 0, 1] = np.nan  # partial on the global first step
    y[1, 4:6] = np.nan  # whole steps inside rank 0's block
    y[2, 9:11, 0] = np.nan  # a partial run across the 10-step boundary
    y[:, 23, 0] = np.nan  # a partial step on a later rank
    d.update(mvc_A=np.array([[0.9, 0.1], [0.0, 0.85]]), mvc_Q=0.3 * np.eye(2),
             mvc_H=np.array([[1.0, 0.2], [0.0, 1.0]]), mvc_R=np.array([[0.4, 0.1], [0.1, 0.5]]),
             mvc_m0=np.zeros(2), mvc_P0=1.5 * np.eye(2), mvc_y=y)

    slds = _jax_slds()
    _, _, y = jax.jit(lambda k: slds.sample(k, T=40, batch_shape=(64,)))(jax.random.PRNGKey(0))
    d["slds_y"] = np.asarray(y)
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def _jax_slds():
    return jmodels.SLDS(
        Pi=jnp.array([[0.95, 0.05], [0.05, 0.95]]), A=jnp.array([0.98, 0.98]),
        Q=jnp.array([0.02, 2.0]), H=jnp.array([1.0, 1.0]), R=jnp.array([0.1, 0.1]),
        prior=(0.0, 1.0))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, per-rank info, per-rank blocks) of one run of the parity world."""
    workdir = tmp_path_factory.mktemp("parity_world")
    inputs = _inputs()
    np.savez(workdir / "inputs.npz", **inputs)
    infos = _chip_smoke().run_parallel_ranks("parallel_parity_rank", WORLD, workdir,
                                             timeout=WORLD_TIMEOUT)
    blocks = [torch.load(workdir / f"rank{r}.pt") for r in range(WORLD)]
    return inputs, infos, blocks


def _whole(blocks, name, dim):
    return torch.cat([b[name] for b in blocks], dim=dim).numpy()


def _close(got, want, tol, rtol=None):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol if rtol is None else rtol, atol=tol)


def _time_mesh():
    return jparallel.make_mesh([("time", WORLD)])


def _jit(fn, *args, **kw):
    """``fn(*args, **kw)`` under ``jax.jit``, the keywords static: JAX's eager
    shard_map and scans take seconds a call on the CPU."""
    return jax.jit(functools.partial(fn, **kw))(*args)


# -- meshes ---------------------------------------------------------------------------------


def test_make_mesh_default_and_two_axes(world):
    _, infos, _ = world
    for rank, info in enumerate(infos):
        meshes = info["meshes"]
        assert meshes["default"] == {"replica": 4}
        assert meshes["two axes"] == {"replica": 2, "time": 2}
        assert meshes["two axes coords"] == {"replica": rank // 2, "time": rank % 2}
        assert meshes["half"] == ({"replica": 2} if rank < 2 else None)
    jax_mesh = jparallel.make_mesh([("replica", 2), ("time", -1)], devices=jax.devices()[:WORLD])
    assert dict(jax_mesh.shape) == infos[0]["meshes"]["two axes"]


def test_make_mesh_errors_as_jax(world):
    _, infos, _ = world
    errors = infos[0]["errors"]
    assert errors["two -1 axes"] == "At most one axis may have size -1"
    assert errors["too large"] == "Mesh needs 16 ranks, only 4 present"
    assert errors["-1 does not divide"] == "Cannot infer -1 axis: 4 ranks not divisible by 3"
    devices = jax.devices()[:WORLD]
    for axes in ([("a", -1), ("b", -1)], [("a", 16)], [("a", 3), ("b", -1)]):
        with pytest.raises(ValueError):
            jparallel.make_mesh(axes, devices=devices)
    assert all(info["errors"] == errors for info in infos)


def test_make_mesh_needs_a_process_group():
    if torch.distributed.is_initialized():
        pytest.skip("this process already belongs to a world")
    with pytest.raises(RuntimeError, match="init_distributed"):
        parallel.make_mesh(device="cpu")


def test_a_world_of_one_without_a_launcher():
    """init_distributed with no arguments and no torchrun makes a world of one;
    its mesh's collectives give back what they got."""
    if torch.distributed.is_initialized():
        pytest.skip("this process already belongs to a world")
    try:
        assert parallel.init_distributed(device="cpu", timeout=timedelta(seconds=60)) == 1
        assert parallel.init_distributed(device="cpu") == 1  # a second call does nothing
        mesh = parallel.make_mesh([("replica", 1), ("time", -1)], device="cpu")
        assert mesh.shape == {"replica": 1, "time": 1} and not mesh.staged("time")
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(parallel.all_gather(x, mesh, "time"), x[None])
        assert torch.equal(parallel.global_sum(x, mesh), x.sum(0))
        assert mesh.stats.calls == 2 and mesh.stats.bytes == 4 * (6 + 3)
    finally:
        torch.distributed.destroy_process_group()


# -- replica sharding ---------------------------------------------------------------------------


def test_replica_sharded_smoothing_matches_single_device(world):
    inputs, infos, blocks = world
    expected = _jit(jmodels.LGSSM(A=0.95, Q=0.5, H=1.0, R=1.0).smooth,
                    jnp.asarray(inputs["replica_y"]))
    assert blocks[0]["replica mean"].shape == (16, 32)
    _close(_whole(blocks, "replica mean", 0), expected.mean, 1e-5)
    _close(_whole(blocks, "replica K1 mean", 0), expected.mean, 1e-4)
    assert all(info["gather is the whole"] for info in infos)


def test_replica_sharded_free_energy_psum(world):
    inputs, _, blocks = world
    expected = float(_jit(jmodels.LGSSM().log_evidence, jnp.asarray(inputs["psum_y"])).sum())
    for b in blocks:  # every rank holds the total
        assert float(b["psum total"]) == pytest.approx(expected, rel=1e-5)


def test_global_sum_and_all_converged(world):
    _, infos, _ = world
    jmesh = jparallel.make_mesh([("replica", WORLD)])
    deltas = jparallel.shard_replicas(jnp.full(64, 1e-8).at[40].set(jnp.nan), jmesh)
    assert not bool(jparallel.all_converged(deltas, 1e-6, jmesh))  # NaN is a violation in JAX too
    for info in infos:
        assert info["arange sum"] == pytest.approx(float(jnp.arange(64.0).sum()))
        assert info["converged"] == [True, False, False]


def test_compiled_generic_path_with_sharded_replicas(world):
    inputs, _, blocks = world
    data = inputs["bernoulli"]
    n = data.shape[0]
    _close(_whole(blocks, "bernoulli a", 0), 1.0 + data.sum(0), 0.0, 1e-6)
    _close(_whole(blocks, "bernoulli b", 0), 1.0 + n - data.sum(0), 0.0, 1e-6)


def test_replica_sharded_streaming(world):
    inputs, _, blocks = world
    expected, _ = _jit(jmodels.HGF().filter, jnp.asarray(inputs["hgf_u"]))
    _close(_whole(blocks, "hgf mu1", 0), expected.mu1, 0.0, 1e-5)
    _close(_whole(blocks, "hgf streamed mu1", 0), expected.mu1, 0.0, 1e-5)


def test_replica_sharded_slds_matches_jax(world):
    inputs, _, blocks = world
    expected = jax.jit(_jax_slds().filter)(jnp.asarray(inputs["slds_y"]))
    _close(_whole(blocks, "slds mean", 0), expected.mean, 1e-6, 1e-5)
    _close(_whole(blocks, "slds probs", 0), expected.regime_probs, 1e-6, 1e-5)
    _close(_whole(blocks, "slds loglik", 0), expected.loglik, 0.0, 1e-5)


# -- time sharding --------------------------------------------------------------------------------


@pytest.mark.parametrize("use_prior", [False, True])
def test_time_sharded_smoothing_matches_jax(world, use_prior):
    inputs, infos, blocks = world
    y = jnp.asarray(inputs["time_y"])
    prior = (0.5, 2.0) if use_prior else None
    tag = "prior" if use_prior else "no prior"
    kw = dict(A=0.9, Q=0.3, H=1.0, R=1.5, prior=prior)
    sharded = _jit(jparallel.lgssm_smooth_time_sharded, y, mesh=_time_mesh(), **kw)
    scan = _jit(lgssm_smooth_scan, y, **kw)
    for field, want in (("mean", sharded.mean), ("variance", sharded.variance)):
        _close(_whole(blocks, f"time {tag} {field}", 1), want, 1e-3)
    _close(_whole(blocks, f"time {tag} mean", 1), scan.mean, 1e-3)
    # One all_gather a sweep, two a call.
    assert all(info["collectives"]["time_sharded"] == 2 for info in infos)


def test_time_sharded_rejects_ragged_split(world):
    _, infos, _ = world
    assert "must divide evenly over the 4 ranks of mesh axis 'time'" in (
        infos[0]["errors"]["ragged time split"])
    with pytest.raises(ValueError):
        jparallel.lgssm_smooth_time_sharded(jnp.ones((2, 62)), mesh=_time_mesh())


def test_replica_and_time_mesh_combined(world):
    """2 x 2: replicas over one axis, time over the other; rank = 2 replica + time."""
    inputs, _, blocks = world
    y = jnp.asarray(inputs["combined_y"])
    rows = [np.concatenate([blocks[2 * r + t]["combined mean"].numpy() for t in range(2)], 1)
            for r in range(2)]
    got = np.concatenate(rows, 0)
    jmesh = jparallel.make_mesh([("replica", 2), ("time", 2)])
    _close(got, _jit(jparallel.lgssm_smooth_time_sharded, y, mesh=jmesh).mean, 1e-3)
    _close(got, _jit(lgssm_smooth_scan, y).mean, 1e-3)


def _mv_args(inputs, prefix):
    return tuple(jnp.asarray(inputs[f"{prefix}_{k}"]) for k in "AQHR") + (
        (jnp.asarray(inputs[f"{prefix}_m0"]), jnp.asarray(inputs[f"{prefix}_P0"])),)


def test_mv_time_sharded_smoothing_matches_jax(world):
    inputs, infos, blocks = world
    y, args = jnp.asarray(inputs["mv_y"]), _mv_args(inputs, "mv")
    sharded = _jit(jparallel.mv_lgssm_smooth_time_sharded, y, *args, mesh=_time_mesh())
    single = _jit(mv_lgssm_smooth, y, *args)
    for field in ("mean", "cov"):
        got = _whole(blocks, f"mv {field}", 1)
        _close(got, getattr(sharded, field), 2e-3)
        _close(got, getattr(single, field), 2e-3)
    assert all(info["collectives"]["mv_time_sharded"] == 2 for info in infos)


def test_mv_time_sharded_component_missing_matches_jax(world):
    inputs, infos, blocks = world
    y, args = jnp.asarray(inputs["mvc_y"]), _mv_args(inputs, "mvc")
    sharded = _jit(jparallel.mv_lgssm_smooth_time_sharded, y, *args, mesh=_time_mesh(),
                   missing="component")
    single = _jit(mv_lgssm_smooth, y, *args, component_missing=True)
    for want in (sharded, single):
        _close(_whole(blocks, "mvc mean", 1), want.mean, 2e-3)
        _close(_whole(blocks, "mvc cov", 1), want.cov, 2e-3, 5e-3)
    assert infos[0]["errors"]["bogus missing"] == (
        "unknown missing='bogus'; expected 'none' or 'component'")


# -- pipelining -----------------------------------------------------------------------------------


@pytest.mark.parametrize("use_prior,n_micro", [(False, None), (True, 2)])
def test_pipelined_smoothing_matches_jax(world, use_prior, n_micro):
    inputs, infos, blocks = world
    y = jnp.asarray(inputs["pipe_y"])
    prior = (0.5, 2.0) if use_prior else None
    tag = "prior" if use_prior else "no prior"
    kw = dict(A=0.9, Q=0.3, H=1.2, R=1.5, prior=prior)
    sharded = _jit(jparallel.lgssm_smooth_pipelined, y, mesh=_time_mesh(), n_micro=n_micro, **kw)
    scan = _jit(lgssm_smooth_scan, y, **kw)
    for field in ("mean", "variance"):
        got = _whole(blocks, f"pipelined {tag} {field}", 1)
        _close(got, getattr(sharded, field), 1e-4)
        _close(got, getattr(scan, field), 1e-4)


def test_pipelined_exchanges_once_a_tick(world):
    """Both sweeps take n_stage + n_micro - 1 ticks, each one exchange."""
    _, infos, _ = world
    for info in infos:
        assert info["collectives"]["pipelined"] == 2 * (WORLD + 2 - 1)


def test_pipelined_smoothing_handles_missing_observations(world):
    inputs, _, blocks = world
    y = jnp.asarray(inputs["pipe_nan_y"])
    expected = _jit(lgssm_smooth_scan, y, A=0.95, Q=0.4, H=1.0, R=1.0)
    _close(_whole(blocks, "pipelined gaps mean", 1), expected.mean, 1e-4)


def test_pipelined_smoothing_input_validation(world):
    _, infos, _ = world
    errors = infos[0]["errors"]
    assert errors["ragged microbatch"] == "batch=6 must divide into 4 microbatches"
    assert errors["not (batch, T)"] == "pipelined smoothing expects (batch, T), got (16,)"
    assert "must divide evenly" in errors["ragged stage split"]


# -- chip_smoke's parallel main path --------------------------------------------------------------

SMALL = {"replica": [64, 20], "time": [16, 64, 2], "mv": [2, 12, 20], "hgf": [64, 48, 16],
         "gabp": [8, 8, 8, 60], "hmc": [8, 3, 40, 60, 8]}


def test_chip_smoke_parallel_main_path_rehearses_on_cpu(tmp_path):
    """chip_smoke's parallel phase in a world of 4 CPU ranks at a small size:
    every sharded path against the single-device path and float64 numpy, the
    kernels' plain versions in place of K1 and K4."""
    ranks = _chip_smoke().run_parallel_ranks("parallel_main_path_rank", WORLD, tmp_path,
                                             timeout=WORLD_TIMEOUT, shapes=SMALL, n_ref=8,
                                             timed=False)
    paths = {c["path"] for c in ranks[0]["checks"]}
    assert {"replica-sharded lgssm_smooth_fused", "all_converged", "pipelined",
            "time-sharded, prior", "vector time-sharded",
            "replica-sharded HGF streaming", "replica-sharded gabp_grid_solve",
            "chain-sharded HMC"} <= paths
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert all(r["backend"] == "gloo" and not any(r["launches"].values()) for r in ranks)


def test_a_failing_rank_fails_the_world_at_once(tmp_path):
    """A rank that raises stops the world within seconds, not at the
    collective timeout, and its traceback is in the error."""
    smoke = _chip_smoke()
    start = time.monotonic()
    with pytest.raises(smoke.SmokeFailure, match="exited with 1(.|\n)*must divide evenly"):
        # 3 replicas do not split over 2 ranks.
        smoke.run_parallel_ranks("parallel_main_path_rank", 2, tmp_path, timeout=60.0,
                                 shapes={**SMALL, "replica": [3, 5]})
    assert time.monotonic() - start < 30.0
