"""Port parity: cortex_tpu_torch.models.fit against cortex_tpu.models.fit.

The scalar fits (``fit_lgssm_ml``, ``fit_lgssm_em``, ``fit_hgf_ml``) run a
few steps on the same numpy data in both packages, on the CPU: Adam in the
port is ``torch.optim.Adam`` with optax's defaults, the EM a closed-form
M-step.  Bar: rtol 1e-4 on the loss traces and the parameters (float32
gradients and sums rounded in other orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cortex_tpu_torch.models import LGSSMParams, fit_hgf_ml, fit_lgssm_em, fit_lgssm_ml

from cortex_tpu.models import fit as jfit

TOL = 1e-4


def _lgssm_data(seed, shape=(16, 40), A=0.8, Q=0.3, R=0.5):
    rng = np.random.default_rng(seed)
    x = np.zeros(shape)
    for t in range(shape[1]):
        x[:, t] = (A * x[:, t - 1] if t else 0.0) + np.sqrt(Q) * rng.normal(size=shape[0])
    return (x + np.sqrt(R) * rng.normal(size=shape)).astype(np.float32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol, atol=tol)


def _same_params(got, want):
    for name in ("A", "log_Q", "log_R", "Q", "R"):
        _close(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("init", [None, (0.2, 0.4, -0.3)], ids=["default-init", "given-init"])
def test_fit_lgssm_ml_matches_jax(init):
    y = _lgssm_data(0)
    port_init = jax_init = None
    if init:
        port_init = LGSSMParams(*(torch.tensor(v) for v in init))
        jax_init = jfit.LGSSMParams(*(jnp.asarray(v, jnp.float32) for v in init))
    params, losses = fit_lgssm_ml(torch.from_numpy(y), n_steps=15, init=port_init)
    want, want_losses = jfit.fit_lgssm_ml(jnp.asarray(y), n_steps=15, init=jax_init)
    assert losses.shape == (15,) and float(losses[-1]) < float(losses[0])
    _close(losses, want_losses)
    _same_params(params, want)


@pytest.mark.parametrize("init", [None, (0.2, 0.4, 0.4)], ids=["default-init", "given-init"])
def test_fit_lgssm_em_matches_jax(init):
    y = _lgssm_data(1)
    port_init = jax_init = None
    if init:
        port_init = LGSSMParams(torch.tensor(init[0]), *torch.log(torch.tensor(init[1:])))
        jax_init = jfit.LGSSMParams(jnp.asarray(init[0]), *jnp.log(jnp.asarray(init[1:])))
    params, lls = fit_lgssm_em(torch.from_numpy(y), n_iters=12, init=port_init)
    want, want_lls = jfit.fit_lgssm_em(jnp.asarray(y), n_iters=12, init=jax_init)
    assert lls.shape == (12,)
    assert (np.diff(lls.numpy()) > -1e-3 * np.abs(lls.numpy()[:-1])).all()  # monotone
    _close(lls, want_lls)
    _same_params(params, want)


def test_fit_hgf_ml_matches_jax():
    rng = np.random.default_rng(2)
    scales = np.repeat([0.05, 0.8, 0.05, 0.8], 15)
    u = np.cumsum(scales * rng.normal(size=(4, 60)), -1).astype(np.float32)
    (omega, theta), losses = fit_hgf_ml(torch.from_numpy(u), n_steps=12)
    (want_omega, want_theta), want_losses = jfit.fit_hgf_ml(jnp.asarray(u), n_steps=12)
    assert losses.shape == (12,) and float(losses[-1]) < float(losses[0])
    _close(losses, want_losses)
    _close(omega, want_omega)
    _close(theta, want_theta)
    assert not omega.requires_grad and not theta.requires_grad
