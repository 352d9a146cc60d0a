"""One case per RGB asymptotic name of the registry's combinator product
(18 names: width segment x noise law x per-mode variant), the PyTorch port
against the JAX reference, at 3 orders on a 600-bin grid; inputs, tolerances
and helpers are those of tests/test_torch_registry.py.

The RGB names keep the one-ulp allowance of tests/test_torch_asymptotic.py:
their l=1 frequencies come from a bisection on a float32 ridge fit, and an
ulp of that fit moves a narrow mixed mode by ~1e-3 of its profile, so each
walker is held to the reference at the port's own fit or at a neighbour one
ulp of Dnu and/or one ulp of the intercept away.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.models import registry as j_registry
from tamcmc_tpu.models.asymptotic import RGBAsymptSpec as JRGBSpec
from tamcmc_tpu_torch.models import asymptotic as t_asymptotic
from tamcmc_tpu_torch.models import build_model
from tamcmc_tpu_torch.models.asymptotic import RGBAsymptSpec

from test_torch_registry import (NU_HI, NU_LO, RGB_NAMES, SPECTRUM, _hold,
                                 _nu, generic_params0)

torch.set_num_threads(1)

ULPS = (0, -1, 1)       # fit offsets tried: ulps of Dnu, of its intercept


def test_the_product_has_18_rgb_names():
    assert len(RGB_NAMES) == 18


@pytest.mark.parametrize("name", RGB_NAMES)
def test_rgb_name_matches_reference(name, monkeypatch):
    kw = dict(n_orders=3, numin=NU_LO, numax_win=NU_HI, n_p_poles=5,
              n_g_poles=12, n_harvey=1)
    jfn, jlay = j_registry.build_model(name, JRGBSpec(**kw))
    nu = _nu()
    params = generic_params0(jlay, np.random.default_rng(len(name)))
    want = np.stack([np.asarray(jax.jit(lambda p: jfn(p, jnp.asarray(nu)))(
        jnp.asarray(r))) for r in params])

    # the ridge fit nudged per walker by `offsets` ulps (module docstring)
    ridge_fit = t_asymptotic._ridge_fit
    offsets = torch.zeros(2, params.shape[0], dtype=torch.int64)

    def nudged(f0):
        dnu, eps_p = ridge_fit(f0)
        icpt = (f0.mean(-1) - dnu * 0.5 * (f0.shape[-1] - 1)).abs()
        eps_p = torch.remainder(
            eps_p + offsets[1] * (torch.nextafter(icpt, icpt + 1.0) - icpt)
            / dnu, 1.0)
        k = offsets[0]
        return torch.where(k > 0, torch.nextafter(dnu, dnu + 1.0),
                           torch.where(k < 0, torch.nextafter(dnu, dnu - 1.0),
                                       dnu)), eps_p

    monkeypatch.setattr(t_asymptotic, "_ridge_fit", nudged)
    tfn, tlay = build_model(name, RGBAsymptSpec(**kw))
    assert (tlay.names, tlay.sizes) == (jlay.names, jlay.sizes)
    tol = SPECTRUM["atol"] + SPECTRUM["rtol"] * np.abs(want)
    worst = np.full(params.shape[0], np.inf)
    best = np.zeros((2, params.shape[0]), np.int64)
    for kd in ULPS:
        for ke in ULPS:
            offsets[0], offsets[1] = kd, ke
            with torch.no_grad():
                got = tfn(torch.tensor(params), torch.tensor(nu)).numpy()
            err = np.max(np.abs(got - want) / tol, axis=1)
            best[:, err < worst] = [[kd], [ke]]
            worst = np.minimum(worst, err)
    offsets.copy_(torch.as_tensor(best))
    _hold(name, jfn, tfn, params, nu, seed=2)
