"""Port parity: cortex_tpu_torch.dists.Dirichlet against cortex_tpu.dists.Dirichlet.

The same float32 ``alpha``, made from a seed with numpy, goes through both
packages on the CPU; every method agrees at rtol 1e-5 (float32 digamma and
gammaln, evaluated by two libraries).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cortex_tpu_torch.dists import Dirichlet

from cortex_tpu.dists import Dirichlet as JDirichlet

RTOL = 1e-5


def _alpha(seed, shape=(3, 4, 5)):
    rng = np.random.default_rng(seed)
    return (rng.gamma(2.0, 1.5, size=shape) + 0.05).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize(
    "method", ["mean", "mean_log", "log_normalizer", "entropy"]
)
def test_moments_and_normalizer_match_jax(method):
    a = _alpha(0)
    port = getattr(Dirichlet(torch.from_numpy(a)), method)
    ref = getattr(JDirichlet(jnp.asarray(a)), method)
    _close(port if method == "mean" else port(), ref if method == "mean" else ref())


def test_product_quotient_and_kl_match_jax():
    a, b = _alpha(1), _alpha(2)
    p, q = Dirichlet(torch.from_numpy(a)), Dirichlet(torch.from_numpy(b))
    jp, jq = JDirichlet(jnp.asarray(a)), JDirichlet(jnp.asarray(b))
    _close((p * q).alpha, (jp * jq).alpha)
    _close((p / q).alpha, (jp / jq).alpha)
    _close(p.kl(q), jp.kl(jq))
    _close(q.kl(p), jq.kl(jp))
    assert torch.allclose(p.kl(p), torch.zeros(3, 4), atol=1e-5)


@pytest.mark.parametrize("axis", [0, 1])
def test_reduce_product_matches_jax_and_pairwise_products(axis):
    a = _alpha(3)
    port = Dirichlet.reduce_product(Dirichlet(torch.from_numpy(a)), axis=axis)
    ref = JDirichlet.reduce_product(JDirichlet(jnp.asarray(a)), axis=axis)
    _close(port.alpha, ref.alpha)
    parts = [Dirichlet(x) for x in torch.from_numpy(a).unbind(axis)]
    pairwise = parts[0]
    for d in parts[1:]:
        pairwise = pairwise * d
    torch.testing.assert_close(port.alpha, pairwise.alpha, rtol=RTOL, atol=1e-5)


def test_kl_to_the_flat_dirichlet_is_negative_entropy_plus_its_normalizer():
    """The flat Dirichlet's density is 1 / B(1), so KL(Dir(α) ‖ Dir(1)) =
    −H(Dir(α)) + log B(1): entropy, KL and log normalizer agree."""
    a = torch.from_numpy(_alpha(4, (6, 3)))
    flat = Dirichlet(torch.ones_like(a))
    d = Dirichlet(a)
    torch.testing.assert_close(d.kl(flat), -d.entropy() + flat.log_normalizer(),
                               rtol=1e-5, atol=1e-5)
