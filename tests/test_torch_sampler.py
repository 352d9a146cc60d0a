"""The PyTorch port's priors, problem and sampler step against the JAX
reference, through tamcmc_tpu_torch.convert.

Both packages get the same problem (the reference demo's arrays, its
JAX-drawn spectrum included) and the same state; random numbers enter
through the `draws=` and `u=` hooks, so one step is compared number for
number.  Tolerances (float32) are stated at each check.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.sampler.mala import mala_step as j_mala_step
from tamcmc_tpu.sampler.state import SamplerState as JState
from tamcmc_tpu.sampler.tempering import tempering_swap as j_swap
from tamcmc_tpu.stats.priors import PriorTable as JPriorTable
from tamcmc_tpu_torch import convert
from tamcmc_tpu_torch.sampler.mala import mala_step as t_mala_step
from tamcmc_tpu_torch.sampler.state import MALAHyper
from tamcmc_tpu_torch.sampler.tempering import tempering_swap as t_swap
from tamcmc_tpu_torch.stats.priors import PriorKind, PriorTable

torch.set_num_threads(1)

T, C = 2, 10       # 2*C >= Df (16, 19, 17): the ensemble covariance estimator


LOG_SIGMA = {"ms_global": -0.6, "kepler_full": 0.6, "subgiant_mixed": -0.6}


def _rel(a, b):
    """max |a - b| / max |b|."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def test_log_prior_all_kinds_matches_jax():
    rows = [("fix", "fix"), ("uni", "uniform", 0.0, 1.0),
            ("gau", "gaussian", 0.5, 0.2), ("jef", "jeffreys", 0.1, 10.0),
            ("ug", "uniform_gaussian", 0.0, 1.0, 0.3),
            ("gug", "gug", 0.0, 1.0, 0.2, 0.4), ("auto", "auto", 1.0, 2.0)]
    tt = PriorTable.from_rows(rows)
    jt = JPriorTable.from_rows(rows)
    assert sorted(int(k) for k in tt.kinds) == [int(k) for k in PriorKind]
    np.testing.assert_array_equal(tt.free_mask, jt.free_mask)
    # one row inside every support, then rows leaving it on either side
    x = np.asarray([[0.3, 0.4, 0.6, 2.0, 0.5, 0.5, 1.5],
                    [0.3, 0.9, 0.1, 9.0, 1.4, -0.3, 1.5],
                    [0.3, 0.2, 1.3, 0.01, 0.2, 1.6, 1.5],
                    [0.3, -0.1, 0.5, 2.0, 0.5, 0.5, 1.5],
                    [0.3, 0.5, 0.5, 12.0, -0.2, 0.5, 1.5]], np.float32)
    lp_j = np.asarray(jax.vmap(jt.log_prior)(jnp.asarray(x)))
    g_j = np.asarray(jax.vmap(jax.grad(jt.log_prior))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    lp_t = tt.log_prior(xt)
    g_t, = torch.autograd.grad(lp_t.sum(), xt)
    assert np.all(np.isfinite(g_t.numpy()))
    np.testing.assert_allclose(lp_t.detach().numpy(), lp_j, rtol=1e-6)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module",
                params=["ms_global", "kepler_full", "subgiant_mixed"])
def pair(request):
    """The reference demo (configs 3, 4 and 5) at 2 orders on a 2000-bin
    grid, the port's problem built from its arrays, and a shared
    non-trivial state."""
    jp, jhp, _, _ = j_make_demo(request.param, seed=0, ngrid=2000,
                                n_orders=2)
    tp = convert.problem_from_reference(jp)
    Df = jp.ndim_free
    rng = np.random.default_rng(7)
    from tamcmc_tpu.sampler.mala import default_init_scales
    u_scale = np.asarray(default_init_scales(jp), np.float32)
    u_center = np.asarray(jp.extract(jp.params0))
    theta = rng.normal(0.0, 0.5, (T, C, Df)).astype(np.float32)
    (logL, logP), (gL, gP) = jax.jit(jp.batched_logparts_and_grad)(
        jnp.asarray(u_center + u_scale * theta))
    a = rng.normal(size=(T, C, Df, Df)) / np.sqrt(Df)
    cov = (np.eye(Df) + a @ np.swapaxes(a, -1, -2)).astype(np.float32)
    chol = np.linalg.cholesky(cov.astype(np.float64)).astype(np.float32)
    arrays = dict(
        theta=theta, logL=np.asarray(logL), logP=np.asarray(logP),
        gradL=np.asarray(gL) * u_scale, gradP=np.asarray(gP) * u_scale,
        mu=rng.normal(0.0, 0.1, (T, C, Df)).astype(np.float32),
        cov=cov, chol=chol,
        ichol=np.linalg.inv(chol.astype(np.float64)).astype(np.float32),
        # a step size at which some walkers of each demo are rejected
        log_sigma=rng.normal(LOG_SIGMA[request.param], 0.2, (T, C))
        .astype(np.float32),
        step=np.asarray(9, np.int32),      # the next step refreshes chol
        naccept=np.zeros(T, np.float32), nprop=np.asarray(9.0, np.float32),
        acc_rate=rng.uniform(0.3, 0.7, (T, C)).astype(np.float32),
        nswap_att=np.zeros(T, np.float32), nswap_acc=np.zeros(T, np.float32),
        scales0=np.ones(Df, np.float32), u_center=u_center, u_scale=u_scale)
    return jp, jhp, tp, arrays


def test_logparts_and_grad_batched_matches_jax(pair):
    jp, _, tp, arrays = pair
    x = arrays["u_center"] + arrays["u_scale"] * arrays["theta"]
    (tl, tP), (tgl, tgp) = tp.batched_logparts_and_grad(torch.as_tensor(x))
    # logL, logP: 1e-5 relative (f32 sums over the grid in another order)
    np.testing.assert_allclose(tl.numpy(), arrays["logL"], rtol=1e-5)
    np.testing.assert_allclose(tP.numpy(), arrays["logP"], rtol=1e-5)
    # gradients: max abs diff / max abs <= 1e-3
    assert _rel(tgl, arrays["gradL"] / arrays["u_scale"]) <= 1e-3
    assert _rel(tgp, arrays["gradP"] / arrays["u_scale"]) <= 1e-3
    lo, lp = tp.batched_log_parts(torch.as_tensor(x))
    np.testing.assert_array_equal(lo.numpy(), tl.numpy())
    np.testing.assert_array_equal(lp.numpy(), tP.numpy())


@pytest.mark.parametrize("estimator", ["ensemble", "walker"])
def test_mala_step_matches_jax(pair, estimator):
    """One adaptive step from the same state with the same draws, at a step
    where the Cholesky refresh fires (step 9 -> 10, dN_chol = 10)."""
    jp, jhp, tp, arrays = pair
    jhp = dataclasses.replace(jhp, cov_estimator=estimator)
    thp = MALAHyper(**dataclasses.asdict(jhp))
    rng = np.random.default_rng(8)
    xi = rng.standard_normal(arrays["theta"].shape).astype(np.float32)
    u = rng.uniform(size=(T, C)).astype(np.float32)
    betas = np.asarray([1.0, 1.0 / 1.5], np.float32)

    jstate = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jn = jax.jit(lambda s, d: j_mala_step(
        jp, jhp, jnp.asarray(betas), s, jax.random.PRNGKey(0), draws=d))(
        jstate, (jnp.asarray(xi), jnp.asarray(u)))
    tn = t_mala_step(tp, thp, torch.as_tensor(betas),
                     convert.state_from_arrays(arrays),
                     draws=(torch.as_tensor(xi), torch.as_tensor(u)))
    got = convert.state_to_arrays(tn)
    want = {f.name: np.asarray(getattr(jn, f.name))
            for f in dataclasses.fields(jn)}

    assert got["step"] == want["step"] == 10
    acc_t = np.any(got["theta"] != arrays["theta"], -1)
    acc_j = np.any(want["theta"] != arrays["theta"], -1)
    np.testing.assert_array_equal(acc_t, acc_j)
    assert 0 < acc_j.sum() < acc_j.size
    # positions and adapted moments: 1e-5 relative to each array's scale
    for f in ("theta", "mu", "cov", "gradL", "gradP"):
        assert _rel(got[f], want[f]) <= 1e-5, f
    # the refreshed factor and its inverse (float32 Cholesky and triangular
    # solve in two libraries): 1e-5 relative
    assert np.abs(want["chol"] - arrays["chol"]).max() > 1e-3
    for f in ("chol", "ichol"):
        assert _rel(got[f], want[f]) <= 1e-5, f
    # log sigma moves by gamma * (min(1, exp(dlog)) - target); dlog carries
    # the float32 rounding of logL, a few ulp of |logL|, so the two agree to
    # gamma times four ulp of |logL|
    gamma = jhp.gain_c0 / (jhp.gain_k0 + 10.0) ** jhp.gain_alpha
    dlog_tol = 4 * np.spacing(np.abs(want["logL"]).max())
    assert np.abs(got["log_sigma"] - want["log_sigma"]).max() \
        <= gamma * dlog_tol
    np.testing.assert_allclose(got["logL"], want["logL"], rtol=1e-5)
    np.testing.assert_allclose(got["naccept"], want["naccept"], rtol=1e-6)


@pytest.mark.parametrize("parity", [0, 1])
def test_tempering_swap_matches_jax(pair, parity):
    _, _, _, arrays = pair
    arrays = dict(arrays)
    T3 = 3              # three rungs: each parity leaves one rung unpaired
    rng = np.random.default_rng(9 + parity)
    for f in ("theta", "gradL", "gradP"):
        arrays[f] = rng.normal(size=(T3, C, arrays[f].shape[-1])) \
            .astype(np.float32)
    for f in ("logL", "logP"):
        arrays[f] = rng.normal(-5000.0, 2.0, (T3, C)).astype(np.float32)
    for f in ("naccept", "nswap_att", "nswap_acc"):
        arrays[f] = np.zeros(T3, np.float32)
    betas = np.asarray([1.0, 0.6, 0.3], np.float32)
    u = rng.uniform(size=(T3, C)).astype(np.float32)
    jn = j_swap(jnp.asarray(betas),
                JState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                jax.random.PRNGKey(0), jnp.asarray(parity), u=jnp.asarray(u))
    tn = t_swap(torch.as_tensor(betas), convert.state_from_arrays(arrays),
                parity, u=torch.as_tensor(u))
    got = convert.state_to_arrays(tn)
    for f in ("theta", "logL", "logP", "gradL", "gradP", "nswap_att",
              "nswap_acc"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jn, f)), f)
    assert np.any(got["theta"] != arrays["theta"])


def test_state_round_trip(pair):
    arrays = pair[3]
    back = convert.state_to_arrays(convert.state_from_arrays(arrays))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, k)
        assert back[k].dtype == np.asarray(v).dtype, k
    assert isinstance(convert.state_from_arrays(arrays).step, int)
