"""The port's analytic targets (tamcmc_tpu_torch/sampler/analytic.py) against
tamcmc_tpu.sampler.analytic: values and gradients of the three targets, the
state init without a prior table, and one injected-draw mala_step on
std_gaussian(3); and the mala_step walker-mean hook alone."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.sampler import analytic as j_an
from tamcmc_tpu.sampler.mala import init_state as j_init
from tamcmc_tpu.sampler.mala import mala_step as j_mala_step
from tamcmc_tpu.sampler.state import MALAHyper as JHyper
from tamcmc_tpu.sampler.state import SamplerState as JState
from tamcmc_tpu_torch.sampler import analytic as t_an
from tamcmc_tpu_torch.sampler.mala import init_state, mala_step
from tamcmc_tpu_torch.sampler.state import MALAHyper, SamplerState

torch.set_num_threads(1)

COV = np.array([[1.0, 0.6, 0.1], [0.6, 2.0, -0.3], [0.1, -0.3, 0.5]])
TARGETS = {"std_gaussian": (lambda m: m.std_gaussian(3), 3),
           "correlated_gaussian": (lambda m: m.correlated_gaussian(COV), 3),
           "bimodal_1d": (lambda m: m.bimodal_1d(4.0), 1)}


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_targets_match_jax(name):
    """logL, logP and both gradients on (T, C, D) points within 1e-6."""
    make, D = TARGETS[name]
    jp, tp = make(j_an), make(t_an)
    assert (tp.ndim_free, tp.free_names, list(tp.free_idx)) == \
        (jp.ndim_free, jp.free_names, list(jp.free_idx))
    np.testing.assert_array_equal(tp.params0.numpy(),
                                  np.asarray(jp.params0))
    x = np.random.default_rng(3).normal(0, 1.5, (4, 5, D)).astype(np.float32)
    (jl, jP), (jgl, jgp) = jp.batched_logparts_and_grad(jnp.asarray(x))
    (tl, tP), (tgl, tgp) = tp.batched_logparts_and_grad(torch.as_tensor(x))
    for got, want in ((tl, jl), (tP, jP), (tgl, jgl), (tgp, jgp)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    lo, lp = tp.batched_log_parts(torch.as_tensor(x))
    np.testing.assert_array_equal(lo.numpy(), tl.numpy())
    np.testing.assert_array_equal(lp.numpy(), tP.numpy())


def test_init_state_without_a_prior_table_matches_jax():
    """The identity map of an analytic target: u_center 0, u_scale 1, the
    initial covariance diag(0.1^2), as the reference builds it."""
    T, C = 2, 4
    js = j_init(j_an.std_gaussian(3), JHyper(), T, C, jax.random.PRNGKey(0))
    ts = init_state(t_an.std_gaussian(3), MALAHyper(), T, C,
                    torch.Generator().manual_seed(0))
    for f in ("u_center", "u_scale", "scales0", "mu", "cov", "chol", "ichol",
              "log_sigma", "acc_rate"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def _state(D, T, C, seed):
    """A non-trivial state of std_gaussian(D) for both packages."""
    rng = np.random.default_rng(seed)
    theta = rng.normal(0, 1, (T, C, D)).astype(np.float32)
    a = rng.normal(size=(T, C, D, D)) / np.sqrt(D)
    cov = (0.2 * np.eye(D) + 0.1 * a @ np.swapaxes(a, -1, -2)) \
        .astype(np.float32)
    chol = np.linalg.cholesky(cov.astype(np.float64)).astype(np.float32)
    arrays = dict(
        theta=theta, logL=-0.5 * (theta**2).sum(-1),
        logP=np.zeros((T, C), np.float32), gradL=-theta,
        gradP=np.zeros_like(theta),
        mu=rng.normal(0, 0.1, (T, C, D)).astype(np.float32), cov=cov,
        chol=chol,
        ichol=np.linalg.inv(chol.astype(np.float64)).astype(np.float32),
        log_sigma=rng.normal(1.5, 0.3, (T, C)).astype(np.float32),
        naccept=np.zeros(T, np.float32), nprop=np.asarray(9.0, np.float32),
        acc_rate=rng.uniform(0.3, 0.7, (T, C)).astype(np.float32),
        nswap_att=np.zeros(T, np.float32), nswap_acc=np.zeros(T, np.float32),
        scales0=np.full(D, 0.1, np.float32), u_center=np.zeros(D, np.float32),
        u_scale=np.ones(D, np.float32))
    draws = (rng.normal(size=(T, C, D)).astype(np.float32),
             rng.uniform(size=(T, C)).astype(np.float32))
    t_state = SamplerState(step=9, **{k: torch.as_tensor(v)
                                      for k, v in arrays.items()})
    j_state = JState(step=jnp.asarray(9, jnp.int32),
                     **{k: jnp.asarray(v) for k, v in arrays.items()})
    return t_state, j_state, draws


@pytest.mark.parametrize("adapt", [True, False], ids=["adapt", "frozen"])
def test_mala_step_on_std_gaussian_matches_jax(adapt):
    """One step with the same injected draws (the next step refreshes the
    Cholesky factor): every field within 1e-6."""
    T, C, D = 3, 4, 3
    t_state, j_state, (xi, u) = _state(D, T, C, seed=11)
    betas = np.asarray([1.0, 0.7, 0.4], np.float32)
    hp = dict(dN_chol=10, dN_mixing=2)
    jn = j_mala_step(j_an.std_gaussian(D), JHyper(**hp), jnp.asarray(betas),
                     j_state, None, adapt=adapt,
                     draws=(jnp.asarray(xi), jnp.asarray(u)))
    tn = mala_step(t_an.std_gaussian(D), MALAHyper(**hp),
                   torch.as_tensor(betas), t_state, None, adapt=adapt,
                   draws=(torch.as_tensor(xi), torch.as_tensor(u)))
    assert tn.step == int(jn.step) == 10
    accepted = (tn.theta != t_state.theta).any(-1)
    assert 0 < int(accepted.sum()) < T * C          # some of each
    for f in ("theta", "logL", "logP", "gradL", "gradP", "mu", "cov", "chol",
              "ichol", "log_sigma", "naccept", "nprop", "acc_rate"):
        np.testing.assert_allclose(getattr(tn, f).numpy(),
                                   np.asarray(getattr(jn, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("estimator", ["ensemble", "walker"])
def test_walker_mean_hook_alone_changes_nothing(estimator):
    """axis_reduce set to the plain mean is the step without it, bit for
    bit; the hook is what every walker mean of the step goes through."""
    T, C, D = 3, 4, 3
    t_state, _, (xi, u) = _state(D, T, C, seed=5)
    betas = torch.as_tensor([1.0, 0.7, 0.4])
    hp = MALAHyper(cov_estimator=estimator, dN_chol=10)
    draws = (torch.as_tensor(xi), torch.as_tensor(u))
    calls = []

    def plain(x, axis, keepdims=False):
        calls.append(axis)
        return torch.mean(x, dim=axis, keepdim=keepdims)

    a = mala_step(t_an.std_gaussian(D), hp, betas, t_state, draws=draws)
    b = mala_step(t_an.std_gaussian(D), hp, betas, t_state, draws=draws,
                  axis_reduce=plain)
    for f in ("theta", "logL", "mu", "cov", "chol", "ichol", "log_sigma",
              "naccept", "acc_rate"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert calls == ([-2, -3, -1] if estimator == "ensemble" else [-1])
