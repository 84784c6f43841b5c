"""The plain references: RTS against the exact Gaussian posterior, the VMP
fit's ELBO, the comparisons, and the controls, which must fail."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench.configs import hmm_reference, lgssm_reference
from perfbench.tests.helpers import BENCH

LGSSM = json.loads((BENCH / "configs" / "lgssm.json").read_text())
HMM = json.loads((BENCH / "configs" / "hmm.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def dense_posterior(y, A, Q, H, R):
    """The exact posterior of every state of one chain with a flat prior on
    the first, by a dense solve of its information form."""
    T = len(y)
    P = np.zeros((T, T))
    h = np.zeros(T)
    for t in range(T):
        P[t, t] += H * H / R
        h[t] += H * y[t] / R
    for t in range(T - 1):
        P[t, t] += A * A / Q
        P[t + 1, t + 1] += 1.0 / Q
        P[t, t + 1] -= A / Q
        P[t + 1, t] -= A / Q
    cov = np.linalg.inv(P)
    return cov @ h, np.diag(cov)


@pytest.mark.parametrize("params", [(1.0, 1.0, 1.0, 1.0), (0.9, 0.5, 2.0, 0.3),
                                    (-1.2, 2.0, 0.7, 1.5)])
def test_rts_is_the_exact_gaussian_posterior(params):
    y = torch.randn(5, 7, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    got = lgssm_reference.smooth(y, *params)
    for row in range(5):
        mean, var = dense_posterior(y[row].numpy(), *params)
        np.testing.assert_allclose(got["mean"][row].numpy(), mean, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got["variance"][row].numpy(), var, rtol=1e-12)


def test_rts_two_steps_by_hand():
    y = torch.tensor([[1.0, 4.0]], dtype=torch.float64)
    got = lgssm_reference.smooth(y, 1.0, 1.0, 1.0, 1.0)
    # Precision [[2, -1], [-1, 2]], information (y0, y1): covariance [[2, 1], [1, 2]] / 3.
    assert torch.allclose(got["mean"], torch.tensor([[2.0, 3.0]], dtype=torch.float64))
    assert torch.allclose(got["variance"], torch.full((1, 2), 2 / 3, dtype=torch.float64))


def _obs(R, T, seed):
    walk = torch.randn(R, T, generator=torch.Generator().manual_seed(seed)).cumsum(-1)
    return walk.abs().long() % HMM["M"]


def test_vmp_elbo_rises_over_iterations():
    obs = _obs(32, HMM["T"], 11)
    elbos = [float(hmm_reference.fit(dict(HMM, n_iterations=n), obs)["elbo"])
             for n in range(1, 13)]
    assert all(b >= a - 1e-9 * abs(a) for a, b in zip(elbos, elbos[1:])), elbos
    assert elbos[-1] > elbos[0]


def test_vmp_reference_marginals_normalise_and_counts_pool():
    obs = _obs(16, HMM["T"], 2)
    out = hmm_reference.fit(dict(HMM, n_iterations=3), obs)
    R, T, K = out["gamma"].shape
    assert (R, T, K) == (16, HMM["T"], HMM["K"])
    assert torch.allclose(out["gamma"].sum(-1), torch.ones(R, T, dtype=torch.float64))
    assert torch.allclose(out["xi_sum"].sum((-2, -1)), torch.full((R,), T - 1.0,
                                                                   dtype=torch.float64))
    # Emission counts pool every replica's marginals: R T in all.
    total = out["emis_alpha"].sum() - HMM["emis_prior"] * HMM["K"] * HMM["M"]
    assert abs(float(total) - R * T) < 1e-8 * R * T


def test_to_tf32_keeps_ten_mantissa_bits_rounding_to_nearest():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, -3.0 - 2**-12, 0.0])
    got = hmm_reference.to_tf32(x)
    assert torch.equal(got, torch.tensor([1.0, 1.0 + 4 * 2**-11, 1.0 + 2**-10, -3.0, 0.0]))
    assert not (hmm_reference.to_tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("module,config,key", [(lgssm_reference, LGSSM, "y"),
                                               (hmm_reference, HMM, "obs")])
def test_compare_reads_zero_on_itself_and_infinite_on_a_wrong_shape(module, config, key):
    x = torch.randn(6, config["T"]).cumsum(-1)
    inputs = {key: x if key == "y" else x.abs().long() % config["M"]}
    want = module.reference(dict(config, n_iterations=2) if key == "obs" else config, inputs)
    assert set(module.compare(config, want, want).values()) == {0.0}
    assert set(module.compare(config, want, want)) == set(config["limits"])
    first = next(iter(want))
    bad = dict(want, **{first: want[first][:3]})
    assert float("inf") in module.compare(config, bad, want).values()
    nan = dict(want, **{first: torch.full_like(want[first], float("nan"))})
    assert float("inf") in module.compare(config, nan, want).values()


def test_lgssm_control_in_bfloat16_fails_the_limits():
    y = torch.randn(64, LGSSM["T"], generator=torch.Generator().manual_seed(1)).cumsum(-1)
    want = lgssm_reference.reference(LGSSM, {"y": y})
    nums = lgssm_reference.compare(LGSSM, lgssm_reference.reference(LGSSM, {"y": y}, "bfloat16"),
                                   want)
    assert any(nums[k] > LGSSM["limits"][k] for k in nums), nums


def test_hmm_control_in_tf32_fails_the_limits():
    obs = _obs(64, HMM["T"], 4)
    want = hmm_reference.reference(HMM, {"obs": obs})
    nums = hmm_reference.compare(HMM, hmm_reference.reference(HMM, {"obs": obs}, "tf32"), want)
    assert any(nums[k] > HMM["limits"][k] for k in nums), nums


def test_references_import_nothing_of_the_program():
    import ast

    for name in ("lgssm_reference", "hmm_reference"):
        tree = ast.parse((BENCH / "configs" / f"{name}.py").read_text())
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops.add((node.module or "").split(".")[0] if not node.level else "perfbench")
        assert tops <= {"__future__", "math", "typing", "torch"}, (name, tops)
