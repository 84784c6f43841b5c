"""Port parity: cortex_tpu_torch.models.LGSSM against cortex_tpu.models.LGSSM,
the converters, the slice end to end, and the port's independence of JAX.

The same numpy inputs, made from a seed, go through both packages on the CPU
in float32.  Tolerances: 1e-5 where both run the same float32 recursion;
2e-4 for matmul and 1e-3 for assoc, the bars of tests/test_lgssm.py.
"""

import ast
import dataclasses
import importlib.util
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cortex_tpu_torch import convert, ops
from cortex_tpu_torch.models import LGSSM

from cortex_tpu import models as jmodels
from cortex_tpu.ops import lgssm_smoother_operator as jax_operator
from cortex_tpu.ops.pallas_kernels import lgssm_smooth_pallas
from test_lgssm import numpy_rts


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
TOL = {"scan": 1e-5, "matmul": 2e-4, "assoc": 1e-3}
PARAMS = [dict(), dict(A=0.9, Q=0.5, H=2.0, R=0.3)]
# One shape for every JAX call: JAX compiles each function once per shape.
SHAPE = (64, 32)


def _walk(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).cumsum(axis=-1).astype(np.float32)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("method", ["scan", "matmul", "assoc"])
@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("prior", [None, (1.5, 4.0)])
def test_smooth_matches_jax_model(method, params, prior):
    y = _walk(0, SHAPE)
    port = LGSSM(**params).smooth(
        torch.from_numpy(y), prior=convert.prior_from_numpy(prior, device="cpu"), method=method
    )
    ref = jmodels.LGSSM(**params).smooth(jnp.asarray(y), prior=prior, method=method)
    _close(port.mean, ref.mean, TOL[method])
    _close(port.variance, ref.variance, TOL[method])


def test_module_call_is_smooth_and_unknown_method_raises():
    model = LGSSM(A=0.9)
    y = torch.from_numpy(_walk(1, (3, 12)))
    assert torch.equal(model(y, method="assoc").mean, model.smooth(y, method="assoc").mean)
    with pytest.raises(ValueError, match="Unknown method"):
        model.smooth(y, method="kernel")


@pytest.mark.parametrize("prior", [None, (0.5, 2.0)])
def test_filter_with_gaps_matches_jax(prior):
    y = _walk(2, SHAPE)
    y[:, 7] = np.nan
    y[2, 20:31] = np.nan
    port = LGSSM(0.95, 0.4, 1.0, 1.2).filter(torch.from_numpy(y), prior=prior)
    ref = jmodels.LGSSM(0.95, 0.4, 1.0, 1.2).filter(jnp.asarray(y), prior=prior)
    _close(port.mean, ref.mean, 1e-5)
    _close(port.variance, ref.variance, 1e-5)


@pytest.mark.parametrize("prior", [(0.0, 1.0), (1.0, 3.0)])
def test_log_evidence_with_gaps_matches_jax(prior):
    y = _walk(3, SHAPE)
    y[1, 3:9] = np.nan
    y[4, 0] = np.nan
    port = LGSSM(0.8, 0.5, 1.3, 0.9).log_evidence(torch.from_numpy(y), prior=prior)
    ref = jmodels.LGSSM(0.8, 0.5, 1.3, 0.9).log_evidence(jnp.asarray(y), prior=prior)
    assert port.shape == SHAPE[:1]
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_sample_shapes_and_statistics():
    model = LGSSM(A=1.0, Q=0.1, H=1.0, R=0.1)
    gen = torch.Generator().manual_seed(0)
    x, y = model.sample(gen, T=50, batch_shape=(64,))
    assert x.shape == (64, 50) and y.shape == (64, 50)
    assert x.dtype == y.dtype == torch.float32
    resid = (y - x).numpy()
    assert abs(resid.mean()) < 0.01
    assert resid.var() == pytest.approx(0.1, abs=0.02)
    steps = np.diff(x.numpy(), axis=-1)
    assert steps.var() == pytest.approx(0.1, abs=0.02)
    again = model.sample(torch.Generator().manual_seed(0), T=50, batch_shape=(64,))
    assert torch.equal(again[1], y)


def test_lgssm_from_numpy_takes_the_jax_dataclass():
    jax_model = jmodels.LGSSM(A=0.9, Q=0.5, H=2.0, R=0.3)
    port = convert.lgssm_from_numpy(dataclasses.asdict(jax_model))
    assert (port.A, port.Q, port.H, port.R) == (0.9, 0.5, 2.0, 0.3)
    with pytest.raises(ValueError, match="not LGSSM parameters"):
        convert.lgssm_from_numpy({"A": 1.0, "B": 2.0})


def test_operator_and_prior_from_numpy():
    op = [np.asarray(a) for a in jax_operator(SHAPE[1], 0.9, 0.5, 2.0, 0.3)]
    S, c, v = convert.operator_from_numpy(op, device="cpu")
    assert S.shape == (32, 32) and c.shape == v.shape == (32,)
    assert S.dtype == torch.float32
    _close(S, op[0], 0.0)
    with pytest.raises(ValueError, match="operator must be"):
        convert.operator_from_numpy((op[0], op[1][:3], op[2]), device="cpu")
    assert convert.prior_from_numpy(None) is None
    pm, pv = convert.prior_from_numpy((np.ones(3), 2.0), device="cpu")
    assert pm.dtype == pv.dtype == torch.float32
    assert pm.shape == (3,) and pv.shape == ()


@pytest.mark.parametrize(
    "fn",
    [ops.lgssm_smoother_operator, convert.operator_from_numpy, convert.prior_from_numpy,
     convert.hmm_from_numpy, convert.hmm_state_from_numpy],
    ids=lambda fn: fn.__name__,
)
def test_entry_points_that_make_tensors_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_slice_end_to_end():
    """R=64 replicas, T=32: every smoother of both packages and the fused
    sweep agree with each other and with the float64 RTS."""
    R_, T = SHAPE
    params = dict(A=0.95, Q=0.6, H=1.1, R=0.8)
    rng = np.random.default_rng(11)
    y = (np.cumsum(rng.normal(size=(R_, T)), -1) + rng.normal(size=(R_, T))).astype(np.float32)
    jax_model = jmodels.LGSSM(**params)
    port = convert.lgssm_from_numpy(dataclasses.asdict(jax_model))
    yt = torch.from_numpy(y)
    rts = [numpy_rts(row, **params) for row in y.astype(np.float64)]
    sm = np.stack([m for m, _ in rts])
    sv = np.stack([v for _, v in rts])
    for method in ("scan", "matmul", "assoc"):
        out = port.smooth(yt, method=method)
        ref = jax_model.smooth(jnp.asarray(y), method=method)
        _close(out.mean, ref.mean, TOL[method])
        _close(out.variance, ref.variance, TOL[method])
        bar = 1e-3 if method == "assoc" else 2e-4
        np.testing.assert_allclose(out.mean.numpy(), sm, rtol=bar, atol=bar)
        np.testing.assert_allclose(out.variance.numpy(), sv, rtol=bar, atol=bar)
    fused = ops.lgssm_smooth_fused(yt, **params)
    pallas = lgssm_smooth_pallas(jnp.asarray(y), **params, tile=16)
    _close(fused.mean, pallas.mean, 1e-4)
    np.testing.assert_allclose(fused.mean.numpy(), sm, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(port.filter(yt).mean.numpy()[:, -1], sm[:, -1], rtol=2e-4)


def test_chip_smoke_main_path_rehearses_on_cpu():
    """chip_smoke's main-path phase, driven on the CPU at a small size: the
    same entry points and checks as on the card, with the plain versions."""
    smoke = _load_chip_smoke()
    checks = smoke.run_main_path(torch, LGSSM, ops, "cpu", R=96, T=40)
    assert {c["path"] for c in checks} >= {"scan", "matmul", "assoc", "lgssm_smooth_fused",
                                           "log_evidence", "scan with NaN gaps"}
    y = _walk(5, (3, 20))
    got = smoke.numpy_rts(y, 0.9, 0.5, 2.0, 0.7)
    for row, mean, var in zip(y, *got):
        want = numpy_rts(row, 0.9, 0.5, 2.0, 0.7)
        np.testing.assert_allclose(mean, want[0], rtol=1e-12)
        np.testing.assert_allclose(var, want[1], rtol=1e-12)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA: non-zero exit and no result line, in the checkout and alone."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                              text=True, timeout=120, cwd=script.parent)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / "cortex_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                  REPO / "kernel_probe.py"]
    assert len(files) > 5
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "cortex_tpu"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
