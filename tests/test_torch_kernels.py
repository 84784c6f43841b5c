"""The port's fused LGSSM sweep (cortex_tpu_torch.ops.kernels) and its build.

On the CPU the wrapper runs the kernel's plain PyTorch version, which is held
against the JAX Pallas kernel in interpret mode, at the shapes and bars of
tests/test_pallas_kernels.py (1e-4; 1e-3 off the default parameters), and
against the scan at 1e-5 where both run on the same float32 recursion.  The
CUDA kernel itself is held against the plain version by the ``cuda``-marked
tests of tests/test_torch_cuda.py, which skip without a card.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cortex_tpu_torch import _build
from cortex_tpu_torch.ops import kernels, lgssm_smooth_scan

from cortex_tpu.ops.pallas_kernels import lgssm_smooth_pallas


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them,
    8-20x slower on small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _walk(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).cumsum(axis=-1).astype(np.float32)


@pytest.mark.parametrize(
    "shape, params, tol",
    [
        ((40, 32), {}, 1e-4),
        ((21, 24), dict(A=0.9, Q=0.5, H=2.0, R=0.7), 1e-3),
    ],
)
def test_plain_version_matches_pallas_interpret(shape, params, tol):
    y = _walk(sum(shape), shape)
    port = kernels.lgssm_smooth_fused_reference(torch.from_numpy(y), **params)
    ref = lgssm_smooth_pallas(jnp.asarray(y), **params, tile=16)
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(ref.mean), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        port.variance.numpy(), np.asarray(ref.variance), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("T", [1, 2, 33])
def test_plain_version_matches_scan(T):
    y = torch.from_numpy(_walk(T, (7, T)))
    a = kernels.lgssm_smooth_fused_reference(y, 0.95, 0.8, 1.2, 0.5)
    b = lgssm_smooth_scan(y, 0.95, 0.8, 1.2, 0.5)
    torch.testing.assert_close(a.mean, b.mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a.variance, b.variance, rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_path_on_cpu_without_counting():
    y = torch.from_numpy(_walk(3, (9, 20)))
    before = dict(kernels.LAUNCHES)
    out = kernels.lgssm_smooth_fused(y, A=0.9, Q=0.5)
    ref = kernels.lgssm_smooth_fused_reference(y, A=0.9, Q=0.5)
    assert kernels.LAUNCHES == before
    assert torch.equal(out.mean, ref.mean) and torch.equal(out.variance, ref.variance)


@pytest.mark.parametrize(
    "y, error",
    [
        (torch.zeros(4, 5, dtype=torch.float64), TypeError),
        (torch.zeros(20), ValueError),
        (torch.zeros(2, 3, 4), ValueError),
        (torch.zeros(0, 5), ValueError),
        (torch.zeros(device="meta", size=(4, 5)), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(y, error):
    with pytest.raises(error):
        kernels.lgssm_smooth_fused(y)


def test_wrapper_rejects_zero_transition():
    with pytest.raises(ValueError, match="A must be non-zero"):
        kernels.lgssm_smooth_fused(torch.ones(2, 3), A=0.0)


@pytest.mark.parametrize(
    "T, tile",
    [(1, 16), (100, 16), (443, 16), (444, 16), (867, 16), (868, 16), (1564, 16), (1565, 8),
     (2764, 8), (2765, 0), (3072, 0)],
)
def test_smem_tile_fits_hopper_shared_memory(T, tile):
    """The largest tile whose block fits in 227 KB; 0 (device memory) past it."""
    assert kernels.smem_tile(T) == tile
    for larger in kernels.SMEM_TILES:
        if larger > tile:
            assert kernels.smem_bytes(larger, T) > kernels.SMEM_LIMIT_BYTES
    if tile:
        assert kernels.smem_bytes(tile, T) <= kernels.SMEM_LIMIT_BYTES
        assert tile % 8 == 0  # whole warps of 8 replicas x 4 segments
        assert kernels.row_pitch(T) >= T and kernels.row_pitch(T) % 4 == 0


@pytest.mark.parametrize("T", [1, 3, 100, 101, 128, 443, 867, 1564])
def test_segment_layout_is_bank_conflict_free(T):
    """A warp is 8 replicas x 4 segments; at every step of their segments its
    32 lanes read 32 distinct shared-memory banks."""
    P, L = kernels.row_pitch(T), kernels.segment_length(T)
    assert P % 8 == 4 and L % 2 == 1 and kernels.SEGMENTS * L >= T
    for k in range(min(L, 8)):
        banks = {(r * P + s * L + k) % 32 for r in range(8) for s in range(kernels.SEGMENTS)}
        assert len(banks) == 32


def _segmented_sweep(y, coef, h_over_r, L, segments):
    """The CUDA kernel's arithmetic (``smooth_segments_kernel`` in
    csrc/lgssm_smooth.cu) in float32 torch ops, vectorized over replicas:
    each segment's local forward and backward passes from zero carries, the
    carries passed across the segments, then the ``carry * product`` fix-up.
    With one segment it is the device-memory path's ``sweep``."""
    gf, gb, var, pf, pb = coef
    n, T = y.shape
    obs = h_over_r * y
    part = torch.empty_like(y)
    bounds = [(min(s * L, T), min(s * L + L, T)) for s in range(segments)]
    ends_f, ends_b = [], []  # local xi_c at the last step, local xi_bc at the first
    for a, b in bounds:
        xf = torch.zeros_like(y[:, :1].squeeze(1))
        xi = torch.zeros_like(xf)
        fwd = []
        for t in range(a, b):
            fwd.append(gf[t] * xi)
            xi = gf[t] * xi + obs[:, t]
        xb = torch.zeros_like(xf)
        for t in range(b - 1, a - 1, -1):
            part[:, t] = obs[:, t] + fwd[t - a] + gb[t] * xb
            xb = gb[t] * xb + obs[:, t]
        ends_f.append(xi)
        ends_b.append(xb)
    c = [torch.zeros(n)] * segments  # true xi_c entering each segment
    d = [torch.zeros(n)] * segments  # true xi_bc leaving each segment
    for s in range(1, segments):
        a, b = bounds[s - 1]
        c[s] = ends_f[s - 1] + c[s - 1] * (pf[b - 1] if b > a else 1.0)
    for s in range(segments - 2, -1, -1):
        a, b = bounds[s + 1]
        d[s] = ends_b[s + 1] + d[s + 1] * (pb[a] if b > a else 1.0)
    mean = torch.empty_like(y)
    for s, (a, b) in enumerate(bounds):
        for t in range(a, b):
            mean[:, t] = (part[:, t] + c[s] * pf[t] + d[s] * pb[t]) * var[t]
    return mean, var.expand(n, T)


@pytest.mark.parametrize("segments", [1, 4, 8])
@pytest.mark.parametrize("params", [{}, dict(A=0.9, Q=0.5, H=2.0, R=0.7),
                                    dict(A=1.3, Q=0.2, H=0.5, R=1.5)])
@pytest.mark.parametrize("T", [1, 2, 3, 40, 101, 3072])
def test_kernel_arithmetic_matches_plain_version(params, T, segments):
    """The kernel's segmented gain form with :func:`sweep_coefficients`
    against the 1/w recursion of the plain version: one float32 sweep
    rounded two ways.  T < segments leaves segments empty; A = 1.3 makes
    the products of the backward gains grow."""
    p = {"A": 1.0, "Q": 1.0, "H": 1.0, "R": 1.0, **params}
    y = torch.from_numpy(_walk(T, (5, T)))
    L = kernels.segment_length(T, segments)
    coef = kernels.sweep_coefficients(p["A"], p["Q"], p["H"], p["R"], T, torch.device("cpu"), L)
    mean, var = _segmented_sweep(y, coef, p["H"] / p["R"], L, segments)
    ref = kernels.lgssm_smooth_fused_reference(y, **p)
    torch.testing.assert_close(mean, ref.mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(var, ref.variance, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T, segment", [(1, 1), (7, 3), (100, 25), (101, 27), (40, 40)])
def test_sweep_coefficients_rows(T, segment):
    """Five float32 rows: the gains and variances, which do not depend on the
    segments, and the products of the gains within each segment."""
    coef = kernels.sweep_coefficients(0.9, 0.5, 2.0, 0.7, T, torch.device("cpu"), segment)
    assert coef.shape == (5, T) and coef.dtype == torch.float32
    whole = kernels.sweep_coefficients(0.9, 0.5, 2.0, 0.7, T, torch.device("cpu"))
    assert torch.equal(coef[:3], whole[:3])
    gf, gb, _, pf, pb = coef.double()
    for a in range(0, T, segment):
        b = min(a + segment, T)
        torch.testing.assert_close(pf[a:b], torch.cumprod(gf[a:b], 0), rtol=1e-6, atol=0)
        torch.testing.assert_close(pb[a:b], torch.cumprod(gb[a:b].flip(0), 0).flip(0),
                                   rtol=1e-6, atol=0)
    assert gf[0] == 0 and gb[T - 1] == 0


def test_build_command_targets_sm90a_and_only_package_sources():
    """One nvcc per source, each compiling that source alone for sm_90a into
    an object, then one link of the objects into the shared library."""
    csrc = Path(_build.__file__).parent / "csrc"
    srcs = _build.sources()
    assert srcs == sorted(csrc.glob("*.cu"))
    assert {p.name for p in srcs} >= {"lgssm_smooth.cu", "hmm_forward_backward.cu"}
    objs = []
    for src in srcs:
        obj = Path(f"{src.stem}.o")
        cmd = _build.compile_command("nvcc", src, obj)
        assert cmd[0] == "nvcc"
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-c" in cmd and "-shared" not in cmd and cmd[cmd.index("-o") + 1] == str(obj)
        assert [Path(a) for a in cmd if a.endswith((".cu", ".cuh", ".cpp", ".c"))] == [src]
        objs.append(obj)
    out = Path("lib.so")
    link = _build.link_command("nvcc", objs, out)
    assert "arch=compute_90a,code=sm_90a" in link
    assert "-shared" in link and link[link.index("-o") + 1] == str(out)
    assert [Path(a) for a in link if a.endswith(".o")] == objs


def test_library_name_keys_on_sources_and_nvcc_version(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_name("release 12.8", [src])
    assert first == _build.library_name("release 12.8", [src])
    assert first != _build.library_name("release 12.9", [src])
    src.write_text("// two\n")
    assert first != _build.library_name("release 12.8", [src])


def test_build_dir_is_git_ignored():
    repo = Path(__file__).resolve().parents[1]
    assert _build.BUILD_DIR.parent == repo / "build"
    assert "build/" in (repo / ".gitignore").read_text().split()


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="needs nvcc"):
        _build.find_nvcc()
