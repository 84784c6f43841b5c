"""Card-only tests of the port: the CUDA kernel against its plain version.

Every test here is marked ``cuda`` and skips without a CUDA card: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor the JAX package,
so it also runs where JAX is absent.  On a machine with a card, from the
root of the checkout (``--noconftest`` because tests/conftest.py sets up JAX)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

The kernel and its plain version run the same 1/w formulas in float32, and
differ only where the compiler fuses a multiply and an add: 1e-4 and 1e-3
are the bars of tests/test_pallas_kernels.py, with ample room.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from cortex_tpu_torch import ops
from cortex_tpu_torch.models import LGSSM
from cortex_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parents[1]
NONDEFAULT = dict(A=0.9, Q=0.5, H=2.0, R=0.7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _walk(seed, shape, device):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=shape).cumsum(axis=-1).astype(np.float32)
    return torch.from_numpy(y).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, params, tol",
    [
        ((300, 100), {}, 1e-4),  # shared-memory path, ragged last block
        ((129, 151), NONDEFAULT, 1e-3),
        ((65, 300), {}, 1e-4),  # 32-replica tile
        ((77, 3072), NONDEFAULT, 1e-3),  # device-memory path
        ((1, 1), {}, 1e-4),
    ],
)
def test_kernel_matches_plain_version(cuda, shape, params, tol):
    y = _walk(sum(shape), shape, cuda)
    launches = kernels.LAUNCHES["lgssm_smooth"]
    got = kernels.lgssm_smooth_fused(y, **params)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lgssm_smooth"] == launches + 1
    want = kernels.lgssm_smooth_fused_reference(y, **params)
    torch.testing.assert_close(got.mean, want.mean, rtol=tol, atol=tol)
    torch.testing.assert_close(got.variance, want.variance, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_rejects_a_strided_tensor_and_counts_nothing(cuda):
    y = _walk(1, (40, 64), cuda).t()
    launches = kernels.LAUNCHES["lgssm_smooth"]
    with pytest.raises(ValueError, match="contiguous"):
        kernels.lgssm_smooth_fused(y)
    assert kernels.LAUNCHES["lgssm_smooth"] == launches


@pytest.mark.cuda
def test_smoothers_on_card_match_the_cpu(cuda):
    model = LGSSM(**NONDEFAULT)
    y = _walk(2, (50, 40), cuda)
    for method in ("scan", "matmul", "assoc"):
        got = model.smooth(y, method=method)
        want = model.smooth(y.cpu(), method=method)
        torch.testing.assert_close(got.mean.cpu(), want.mean, rtol=2e-4, atol=2e-4)
    fused = ops.lgssm_smooth_fused(y, **NONDEFAULT)
    torch.testing.assert_close(fused.mean.cpu(), model.smooth(y.cpu()).mean,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_chip_smoke_main_path_on_card(cuda):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = kernels.LAUNCHES["lgssm_smooth"]
    checks = smoke.run_main_path(torch, LGSSM, ops, "cuda", R=500, T=60)
    assert kernels.LAUNCHES["lgssm_smooth"] == launches + 1
    assert any(c["path"] == "lgssm_smooth_fused" for c in checks)
