"""Port parity: ``cortex_tpu_torch.serve`` against ``cortex_tpu.serve``.

``tests/test_serve.py``'s seven cases, on the port, held to the JAX
functions on the same numpy inputs at that file's bars: the compiled and the
exported function against ``jax.jit`` at rtol 1e-6, the bucketed server at
rtol 1e-5, atol 1e-6.  Each is also held to the port's own eager call, which
an exported program must equal.  Besides: a call that does not match the
example raises ``TypeError`` (as JAX's compiled call does), outputs are
copies, the kernels are one operator node each in an exported CPU graph, and
``chip_smoke.py``'s serving phase rehearsed at a small size.

``torch.export`` traces the port's scan smoother into ~30 nodes a step, so
the scan cases run at T <= 16; the server cases that check only the bucket
ladder serve the K1 operator, one node.
"""

import os
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from cortex_tpu_torch import models as tmodels
from cortex_tpu_torch import ops as tops
from cortex_tpu_torch import serve
from cortex_tpu_torch.ops import kernels

from cortex_tpu.models import LGSSM as JaxLGSSM

PARAMS = dict(A=0.9, Q=0.5, H=1.0, R=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smooth_fns():
    """The same function in both packages: the LGSSM scan smoother's means
    and variances."""
    jmodel, tmodel = JaxLGSSM(**PARAMS), tmodels.LGSSM(**PARAMS)

    def jfn(y):
        marg = jmodel.smooth(y, method="scan")
        return marg.mean, marg.variance

    def tfn(y):
        marg = tmodel.smooth(y, method="scan")
        return marg.mean, marg.variance

    return jax.jit(jfn), tfn


def _k1(y):
    return tops.lgssm_smooth_fused(y, **PARAMS)


def _close(got, want, **tol):
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.fixture(scope="module")
def compiled16():
    """The scan smoother compiled at 16 x 16, and its example."""
    _, tfn = _smooth_fns()
    y = np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32)
    return serve.aot_compile(tfn, torch.from_numpy(y)), y


def test_aot_compile_matches_jit(compiled16):
    compiled, y = compiled16
    jfn, tfn = _smooth_fns()
    got = compiled(torch.from_numpy(y))
    _close(got, jfn(jnp.asarray(y)), rtol=1e-6)
    for g, w in zip(got, tfn(torch.from_numpy(y))):
        assert torch.equal(g, w)


def test_aot_cost_and_memory_analysis_exposed(compiled16):
    compiled, _ = compiled16
    cost = compiled.cost_analysis()
    assert isinstance(cost, dict) and cost.get("flops", 0) > 0
    assert cost["bytes accessed"] > 0
    memory = compiled.memory_analysis()
    assert memory is not None
    assert memory.argument_size_in_bytes == 16 * 16 * 4
    assert memory.output_size_in_bytes == 2 * 16 * 16 * 4
    assert memory.graph_pool_bytes is None  # no graph on the CPU
    assert "graph" in compiled.as_text().lower()


def test_a_call_unlike_the_example_raises_type_error(compiled16):
    compiled, y = compiled16
    for bad in (torch.zeros((16, 15)), torch.zeros((16, 16), dtype=torch.float64),
                torch.zeros((17, 16))):
        with pytest.raises(TypeError, match="differ"):
            compiled(bad)
    with pytest.raises(TypeError, match="structure"):
        compiled(torch.from_numpy(y), torch.from_numpy(y))


def test_outputs_are_copies(compiled16):
    compiled, y = compiled16
    first = compiled(torch.from_numpy(y))
    kept = [t.clone() for t in first]
    compiled(torch.from_numpy(2 * y + 1))
    for g, w in zip(first, kept):
        assert torch.equal(g, w)


def test_export_roundtrip_matches_original():
    jfn, tfn = _smooth_fns()
    y = np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32)
    blob = serve.export_serialized(tfn, torch.from_numpy(y))
    assert isinstance(blob, (bytes, bytearray)) and len(blob) > 100
    rehydrated = serve.load_serialized(bytes(blob))
    got = rehydrated(torch.from_numpy(y))
    _close(got, jfn(jnp.asarray(y)), rtol=1e-6)
    for g, w in zip(got, tfn(torch.from_numpy(y))):
        assert torch.equal(g, w)


def test_the_kernels_export_as_one_operator_node_each():
    """K1 in an exported CPU graph is one node of the package's operator (the
    plain version's loop would unroll into hundreds); the HMM and HGF
    kernels' operators trace the same way."""
    y = torch.zeros((8, 16))
    lik = torch.full((8, 16, 4), 0.5)
    u = torch.zeros((8, 16))
    hmm = tmodels.HMM(4, torch.log(torch.full((4,), 0.25)))
    log_A = torch.log(torch.full((4, 4), 0.25))
    for fn, x, name in (
        (_k1, y, "lgssm_smooth"),
        (lambda x: tops.hmm_forward_backward_fused(x, torch.exp(log_A), torch.exp(hmm.log_pi)),
         lik, "hmm_fb"),
        (lambda x: hmm.smooth(torch.log(x), log_A, method="fused"), lik, "hmm_fb_counts"),
        (lambda x: tmodels.HGF().filter(x, method="fused", tracks=("mu1",)), u, "hgf_filter"),
    ):
        exported, _ = serve._export(fn, (x,))
        calls = [n for n in exported.graph.nodes if n.op == "call_function"]
        ours = [n for n in calls if getattr(n.target, "namespace", None) == kernels.NAMESPACE]
        assert [n.target.__name__ for n in ours] == [f"{name}.default"], name
    # K1's node: the graph is the operator and the unpacking of its outputs.
    assert len([n for n in serve._export(_k1, (y,))[0].graph.nodes
                if n.op == "call_function"]) == 3
    # Its cost is the kernel's own count: 8 operations and 12 bytes a replica-step.
    cost = serve.aot_compile(_k1, y).cost_analysis()
    assert cost == {"flops": 8.0 * 8 * 16, "bytes accessed": 12.0 * 8 * 16 + 12.0 * 16}


def test_persistent_cache_populates(tmp_path):
    """A fresh process that enables the cache builds the native signal core
    into it (no nvcc here for the kernels); chip_smoke.py's persistent-cache
    check adds a second process that finds it there."""
    cache_dir = tmp_path / "cache"
    report = chip_smoke._fresh_process(chip_smoke.USE_CACHE.format(
        repo=chip_smoke.REPO, cache=str(cache_dir), device="cpu"), tmp_path)
    assert not report["native"]["found"] and report["native"]["in_cache"]
    assert os.path.isdir(cache_dir)
    assert len(os.listdir(cache_dir)) >= 1


def test_enable_persistent_cache_points_the_build_directory(tmp_path, monkeypatch):
    from cortex_tpu_torch import _build
    from cortex_tpu_torch.native import bindings

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)  # restored after the test
    for _ in range(2):  # safe to call more than once
        serve.enable_persistent_cache(str(tmp_path / "cache"))
    assert _build.BUILD_DIR == (tmp_path / "cache").resolve()
    assert bindings.library_path().parent == _build.BUILD_DIR
    assert os.path.isdir(tmp_path / "cache")


def test_bucketed_server_pads_and_slices_correctly():
    jfn, tfn = _smooth_fns()
    example = (torch.zeros((8, 12)),)
    server = serve.BucketedServer(tfn, example, max_batch=64, min_bucket=8)
    rng = np.random.default_rng(2)
    for n in (3, 8, 9, 33, 64):
        y = rng.normal(size=(n, 12)).astype(np.float32)
        got = server(torch.from_numpy(y))
        assert got[0].shape == (n, 12)
        _close(got, jfn(jnp.asarray(y)), rtol=1e-5, atol=1e-6)
        for g, w in zip(got, tfn(torch.from_numpy(y))):
            assert torch.equal(g, w)
    # 3→8, 8→8, 9→16, 33→64, 64→64: exactly three programs compiled.
    assert server.compiled_buckets == (8, 16, 64)


def test_bucketed_server_rejects_oversize_and_precompiles():
    example = (torch.zeros((4, 10)),)
    server = serve.BucketedServer(_k1, example, max_batch=16, min_bucket=4, precompile=True)
    assert server.compiled_buckets == (4, 8, 16)
    with pytest.raises(ValueError, match="exceeds"):
        server(torch.zeros((17, 10)))


def test_bucketed_server_example_larger_than_small_buckets():
    """An example batch bigger than a bucket slices down, not pads by a
    negative width."""
    jfn, tfn = _smooth_fns()
    example = (torch.zeros((32, 10)),)
    server = serve.BucketedServer(tfn, example, max_batch=64, min_bucket=8)
    y = np.random.default_rng(3).normal(size=(5, 10)).astype(np.float32)
    got = server(torch.from_numpy(y))
    _close(got, jfn(jnp.asarray(y)), rtol=1e-5, atol=1e-6)
    assert server.compiled_buckets == (8,)


def test_bucketed_server_keeps_named_tuples():
    """Outputs are sliced back by the tree helper, so a named tuple (K1's
    ChainMarginals, the HMM's posterior) keeps its class and fields."""
    server = serve.BucketedServer(_k1, (torch.zeros((8, 6)),), max_batch=16, min_bucket=8)
    y = torch.from_numpy(np.random.default_rng(4).normal(size=(5, 6)).astype(np.float32))
    got = server(y)
    assert type(got) is tops.ChainMarginals
    assert torch.equal(got.mean, _k1(y).mean) and got.variance.shape == (5, 6)


def test_serve_phase_rehearsed_on_the_cpu(tmp_path):
    """chip_smoke.py's serving phase at a small size on the CPU: every
    answer through a server equal to the eager call and within the float64
    bars, the exported K1 function loaded in a fresh process, the HGF stream
    resumed bit for bit, the diagnostics."""
    shapes = {**chip_smoke.SERVE_SHAPES,
              "lgssm": {"T": 12, "max_batch": 32, "min_bucket": 8, "requests": (3, 9, 32),
                        "precompile": True},
              "hmm": {"T": 10, "K": 4, "M": 8, "max_batch": 32, "min_bucket": 8,
                      "requests": (5, 17)},
              "export": (20, 12), "hgf": (16, 48, 6), "gmm": (8, 32), "ar1": (8, 400, 0.5)}
    run = chip_smoke.run_servers(torch, tmodels, tops, serve, "cpu", shapes=shapes, n_ref=8)
    assert len(run["checks"]) == 3 + 2 + 2
    assert all(v == 0.0 for c in run["checks"] for v in c["max_abs_diff_vs_eager"].values())
    assert run["servers"]["lgssm"][0].compiled_buckets == (8, 16, 32)
    export = chip_smoke.run_export(torch, tops, serve, "cpu", tmp_path, shape=shapes["export"])
    assert export["kernel_nodes"] == 1
    checks = chip_smoke.run_resume_and_diag(torch, tmodels, "cpu", tmp_path, shapes=shapes,
                                            n_ref=8)
    assert checks[0]["kept"] == ["ckpt_3.npz", "ckpt_4.npz"]
    assert checks[0]["chunks"] == 8
    assert checks[2]["rel_err_ess"] < chip_smoke.DIAG_RTOL


def test_importing_the_package_loads_the_slice_lazily(tmp_path):
    """``import cortex_tpu_torch`` loads no module of this slice, nor the
    kernels' (so it builds nothing); they load on first attribute access, as
    the JAX package's do."""
    script = (
        "import json, sys; sys.path.insert(0, {repo!r}); import cortex_tpu_torch\n"
        "slice_ = ('serve', 'checkpoint', 'diag', 'viz', 'native', 'ops')\n"
        "loaded = [m for m in slice_ if 'cortex_tpu_torch.' + m in sys.modules]\n"
        "assert cortex_tpu_torch.serve.BucketedServer and cortex_tpu_torch.viz.signal_to_dot\n"
        "print(json.dumps({{'loaded': loaded}}))\n"
    ).format(repo=chip_smoke.REPO)
    assert chip_smoke._fresh_process(script, tmp_path) == {"loaded": []}
