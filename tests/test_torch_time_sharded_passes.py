"""The time-sharded smoother's local sweep by passes, on the CPU.

``ops/kernels_time_sharded.py``'s three passes run their plain versions on a
CPU block: the kernels' segments and arithmetic, vectorised over lanes and
segments.  Each rank of a world of threads (``chip_smoke.time_sharded_ranks``,
the elements exchanged through a shared board) runs
``parallel/time_sharded.py``'s ``_sweep`` on its block; the joined marginals
are held to the single-device smoother in float64 (1e-10: the same algebra
in another order; 1e-4 for a float32 block, the bar of
tests/test_torch_cuda.py's K1 tests: float32 rounding over a walk's
magnitude), and to the JAX package's time-sharded smoother on a mesh of as
many of conftest's virtual CPU devices as the world has ranks, on the same
inputs (1e-10 in float64, 1e-4 in float32).  ``MIN_SEGMENT`` is lowered to
cut these short blocks into several segments, some of them empty.  The
kernels themselves run on the card only (tests/test_torch_cuda.py).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cortex_tpu_torch.ops import chains, kernels
from cortex_tpu_torch.ops import kernels_time_sharded as kts
from cortex_tpu_torch.parallel import time_sharded

import cortex_tpu.parallel as jparallel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]
# (lanes, T, ranks): blocks of 16 steps, 30 (no multiple of 4), 80, 7 and 33
# (a chunk and one step), on 1 to 4 ranks.
SHAPES = [(5, 64, 4), (3, 90, 3), (37, 160, 2), (1, 7, 1), (2, 132, 4)]
PARAMS = [(1.0, 1.0, 1.0, 1.0), (0.9, 0.3, 1.0, 1.5), (0.9, 0.5, 2.0, 0.7)]
# MIN_SEGMENT: up to 32 segments (empty ones past the block's end), a few, one.
MIN_SEGMENTS = [1, 4, 300]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke()


def _walk(seed, lanes, T, dtype):
    y = np.random.default_rng(seed).normal(size=(lanes, T)).cumsum(-1)
    return torch.from_numpy(y).to(dtype)


def _prior(seed, lanes, dtype):
    rng = np.random.default_rng(seed + 1)
    return (torch.from_numpy(rng.normal(size=lanes)).to(dtype),
            torch.from_numpy(rng.random(lanes) + 0.5).to(dtype))


@pytest.mark.parametrize("prior", [False, True], ids=["no prior", "prior"])
@pytest.mark.parametrize("min_segment", MIN_SEGMENTS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_passes_give_the_float64_smoothers_marginals(shape, min_segment, prior, monkeypatch):
    monkeypatch.setattr(kts, "MIN_SEGMENT", min_segment)
    lanes, T, ranks = shape
    params = (0.9, 0.3, 1.0, 1.5)
    y = _walk(sum(shape), lanes, T, torch.float64)
    p = _prior(T, lanes, torch.float64) if prior else None
    mean, var = SMOKE.time_sharded_ranks(torch, y, ranks, params, p)
    want = chains.lgssm_smooth_scan(y, *params, prior=p)
    torch.testing.assert_close(mean, want.mean, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(var, want.variance, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("params", PARAMS, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_float32_passes_give_the_float64_smoothers_marginals(shape, params, monkeypatch):
    monkeypatch.setattr(kts, "MIN_SEGMENT", 4)
    lanes, T, ranks = shape
    y = _walk(T, lanes, T, torch.float64)
    p = _prior(lanes, lanes, torch.float64)
    got = SMOKE.time_sharded_ranks(torch, y.float(), ranks, params, tuple(q.float() for q in p))
    want = chains.lgssm_smooth_scan(y, *params, prior=p)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g.double(), w, rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_marginals(shape, params, prior, dtype):
    """The JAX package's time-sharded smoother on :func:`_walk`'s inputs, its
    time axis over ``ranks`` devices, under ``jax.jit`` (its eager shard_map
    takes seconds a call on the CPU); float64 with x64 enabled."""
    lanes, T, ranks = shape
    y = _walk(T + lanes, lanes, T, dtype).numpy()
    p = tuple(q.numpy() for q in _prior(T, lanes, dtype)) if prior else None
    mesh = jparallel.make_mesh([("time", ranks)])
    with jax.enable_x64(dtype == torch.float64):
        fn = functools.partial(jparallel.lgssm_smooth_time_sharded, A=params[0], Q=params[1],
                               H=params[2], R=params[3], mesh=mesh, prior=p)
        out = jax.jit(fn)(jnp.asarray(y))
        return tuple(np.asarray(field) for field in out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("prior", [False, True], ids=["no prior", "prior"])
@pytest.mark.parametrize("params", PARAMS[:2], ids=str)
@pytest.mark.parametrize("min_segment", MIN_SEGMENTS)
@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_passes_match_the_jax_time_sharded_smoother(shape, min_segment, params, prior, dtype,
                                                    monkeypatch):
    """Every rank of the world through the passes, against JAX's smoother
    sharded over as many devices: ranks first, middle and last, each folding
    the gathered prefix and suffix."""
    monkeypatch.setattr(kts, "MIN_SEGMENT", min_segment)
    lanes, T, ranks = shape
    y = _walk(T + lanes, lanes, T, dtype)
    p = _prior(T, lanes, dtype) if prior else None
    got = SMOKE.time_sharded_ranks(torch, y, ranks, params, p)
    want = _jax_marginals(shape, params, prior, dtype)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == dtype and w.dtype == g.numpy().dtype
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)


def test_a_block_with_batch_axes_keeps_its_shape_and_a_scalar_prior():
    """A ``(2, 3, T)`` block is six lanes; a number prior reaches every lane."""
    y = _walk(5, 6, 48, torch.float64)
    mean, var = SMOKE.time_sharded_ranks(torch, y.view(2, 3, 48), 2, PARAMS[1], (0.5, 2.0))
    want = chains.lgssm_smooth_scan(y, *PARAMS[1], prior=(0.5, 2.0))
    assert mean.shape == (2, 3, 48)
    torch.testing.assert_close(mean.reshape(6, 48), want.mean, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(var.reshape(6, 48), want.variance, rtol=1e-10, atol=1e-10)


def test_the_plan_cuts_the_cells_block_into_sixteen_segments():
    """10,000 lanes x 16,384 steps: 16 segments of 1,024 steps, 160,000
    threads; short blocks take one segment; every plan covers the block in
    whole chunks."""
    assert kts.plan(10_000, 16_384) == (16, 1024)
    assert kts.plan(1, 7) == (1, 32)
    assert kts.plan(300, 128) == (1, 128)
    for lanes, T in [(10_000, 16_384), (1, 100_000), (50_000, 4_000), (3, 1_000)]:
        segments, length = kts.plan(lanes, T)
        assert length % kts.CHUNK == 0 and segments * length >= T
        assert lanes * segments <= kts.TARGET_THREADS or segments == 1


def test_local_sweep_rejects_what_the_kernels_do_not_take():
    y = _walk(1, 4, 32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        kts.LocalSweep(y.t(), 1.0, 1.0, 1.0, 1.0, first=True, last=True)
    with pytest.raises(ValueError, match="first step"):
        kts.LocalSweep(y, 1.0, 1.0, 1.0, 1.0, first=False, last=True,
                       prior=(torch.zeros(4), torch.ones(4)))
    with pytest.raises(ValueError, match="non-empty"):
        kts.LocalSweep(y[0], 1.0, 1.0, 1.0, 1.0, first=True, last=True)
    with pytest.raises(ValueError, match=r"\(4,\) torch.float32 vector"):
        kts.LocalSweep(y, 1.0, 1.0, 1.0, 1.0, first=True, last=True,
                       prior=(torch.zeros(4, dtype=torch.float64), torch.ones(4)))
    sweep = kts.LocalSweep(y, 1.0, 1.0, 1.0, 1.0, first=True, last=True)
    sweep.filter_total()
    with pytest.raises(ValueError, match="vector"):
        sweep.filter_fillin(torch.zeros(3), torch.zeros(4))


class _Mesh:
    """The parts of a mesh that ``lgssm_smooth_time_sharded`` reads, for one
    rank."""

    def __init__(self, ranks, rank):
        self.shape, self.rank = {"time": ranks}, rank

    def axis_index(self, axis):
        return self.rank


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocks_on_the_host_run_the_plain_passes_and_launch_nothing(dtype, monkeypatch):
    """What runs is read from the block: CPU blocks, float32 or float64, run
    the passes' plain versions; no kernel is launched and no launch is
    counted."""
    plain = []
    monkeypatch.setattr(kts.LocalSweep, "_launch",
                        lambda *args: pytest.fail("launched a kernel"))
    original = kts.LocalSweep._filter_total_plain
    monkeypatch.setattr(kts.LocalSweep, "_filter_total_plain",
                        lambda sweep: plain.append(sweep.y.dtype) or original(sweep))
    monkeypatch.setattr(time_sharded, "_gather_elems", lambda elem, mesh, axis: [elem])
    y = _walk(2, 3, 40, dtype)
    before = dict(kernels.LAUNCHES)
    got = time_sharded.lgssm_smooth_time_sharded(y, *PARAMS[1], mesh=_Mesh(1, 0))
    assert plain == [dtype] and kernels.LAUNCHES == before
    want = chains.lgssm_smooth_scan(y, *PARAMS[1])
    torch.testing.assert_close(got.mean, want.mean, rtol=1e-4, atol=1e-4)
    assert got.mean.dtype == dtype
