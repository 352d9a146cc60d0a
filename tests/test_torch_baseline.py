"""The PyTorch port on BASELINE configs 1 and 2 against the JAX reference:
the five analytic builders of models/test_models.py, config 2's chi_square
likelihood with its per-bin sigma, and the demos the port refuses.

Tolerances as tests/test_torch_model.py: model values rtol 1e-4, atol 1e-5
(full spectra); gradients rtol 3e-3, atol 3e-4 of the gradient scale; logL
1e-5 relative.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.models import build_model as j_build_model
from tamcmc_tpu_torch import convert
from tamcmc_tpu_torch.demos import make_demo as t_make_demo

torch.set_num_threads(1)

SPECTRUM = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=3e-3, atol=3e-4)


def _rows(rng, lo_hi, n=4):
    lo, hi = np.asarray(lo_hi, np.float64).T
    return rng.uniform(lo, hi, (n, lo.shape[0])).astype(np.float32)


# (model name, grid, per-parameter draw ranges)
BUILDERS = {
    "model_Test_Gaussian": (
        np.linspace(0.0, 100.0, 401),
        [(1, 10), (40, 60), (2, 8), (0.1, 1)]),
    "model_Harvey_Gaussian": (
        np.linspace(1.0, 3000.0, 601),
        [(20, 80), (1e-3, 5e-3), (2, 4), (0.1, 1), (3, 9), (1500, 2500),
         (100, 300)]),
    "model_Single_Lorentzian": (
        np.linspace(10.0, 90.0, 801),
        [(5, 15), (45, 55), (1, 3), (0.5, 1.5)]),
    "model_Harvey_Background": (
        np.linspace(1.0, 4000.0, 1001),
        [(200, 400), (0.01, 0.03), (3, 5), (30, 70), (2e-3, 6e-3), (3, 5),
         (5, 15), (5e-4, 1e-3), (1.5, 2.5), (0.2, 0.4)]),
    "model_Kallinger2014_Gaussian": (
        np.linspace(0.0, 280.0, 701),
        [(30, 80), (20, 60), (30, 80), (80, 150), (0.5, 2), (2, 6),
         (100, 180), (5, 20)]),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_test_models_match_jax(name):
    grid, ranges = BUILDERS[name]
    nu = grid.astype(np.float32)
    rng = np.random.default_rng(len(name))
    params = _rows(rng, ranges)
    g = rng.normal(size=(params.shape[0], nu.shape[0])).astype(np.float32)
    jfn, jlayout = j_build_model(name)
    _, tfn, tlayout = convert.build_model(name)
    assert (tlayout.names, tlayout.sizes) == (jlayout.names, jlayout.sizes)
    jnu = jnp.asarray(nu)
    jmodel = jax.vmap(lambda r: jfn(r, jnu))
    want = np.asarray(jmodel(jnp.asarray(params)))
    want_g = np.asarray(jax.grad(lambda p: jnp.sum(g * jmodel(p)))(
        jnp.asarray(params)))
    leaf = torch.tensor(params, requires_grad=True)
    out = tfn(leaf, torch.tensor(nu))
    got_g, = torch.autograd.grad(out, leaf, torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), want, **SPECTRUM)
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g.numpy() / scale, want_g / scale, **GRAD)


def test_harvey_background_chi_square_matches_jax():
    """Config 2: the Gaussian likelihood over the smoothed spectrum with the
    reference's per-bin sigma, values and gradients, batched."""
    jp, _, _, _ = j_make_demo("harvey_background", seed=0)
    tp = convert.problem_from_reference(jp)
    assert tp.likelihood == "chi_square" and tp.sigma_spec is not None
    rng = np.random.default_rng(4)
    x0 = np.asarray(jp.extract(jp.params0))
    x = (x0 * (1 + 0.05 * rng.standard_normal((2, 3, x0.shape[0])))
         ).astype(np.float32)
    (jl, jP), (jgl, jgp) = jax.jit(jp.batched_logparts_and_grad)(
        jnp.asarray(x))
    (tl, tP), (tgl, tgp) = tp.batched_logparts_and_grad(torch.as_tensor(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-5)
    for got, want in ((tgl, jgl), (tgp, jgp)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy() / scale, want / scale, **GRAD)


def test_unported_and_unknown_demos_raise():
    """No demo of the reference is left unported: `ajfit`, the last one,
    builds (its parity is in tests/test_torch_ajfit.py); an unknown name
    raises and lists the demos there are."""
    problem, _, _, meta = t_make_demo("ajfit")
    assert meta["model"] == "model_ajfit" and problem.ndim_free == 15
    with pytest.raises(KeyError, match="kepler_full.*ajfit"):
        t_make_demo("no_such_demo")
