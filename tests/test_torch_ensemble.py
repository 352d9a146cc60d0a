"""The port's stacked multi-star ensemble (tamcmc_tpu_torch/sampler/
ensemble.py) against the reference's and against its own single-star step.

Stackability refuses and accepts what tamcmc_tpu.sampler.ensemble does, on
the cases of tests/test_ensemble.py, with the same messages; the merged
window segments of stars with offset combs are the reference's.  One
stacked step (S, T, C, ...) through the `draws=` / `u=` hooks equals, star
by star, the single-star step on each star's problem around the shared
model closure: every field within 1e-6 of its max (float32; the products
run batched over another number of walkers).  The same stacked step, fed
the same draws, equals the reference ensemble's step (its per-star step
vmapped over the star axis) within the single-star parity test's
tolerances.  Inputs come from numpy seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tamcmc_tpu.models import build_model as j_build_model
from tamcmc_tpu.models.ms_global import MSGlobalSpec as JSpec
from tamcmc_tpu.sampler import ensemble as j_ens
from tamcmc_tpu.sampler.problem import Problem as JProblem
from tamcmc_tpu.stats.priors import PriorTable as JPriors
from tamcmc_tpu_torch.convert import problem_from_reference
from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.models import build_model
from tamcmc_tpu_torch.sampler import ensemble as ens
from tamcmc_tpu_torch.sampler.driver import make_record
from tamcmc_tpu_torch.sampler.mala import init_state, mala_step
from tamcmc_tpu_torch.sampler.problem import Problem
from tamcmc_tpu_torch.sampler.state import MALAHyper, SamplerState
from tamcmc_tpu_torch.sampler.tempering import (make_beta_ladder,
                                                tempering_swap)
from tamcmc_tpu_torch.stats.priors import PriorTable

torch.set_num_threads(1)

STEP = 1e-6
ROWS = [("H", "jeffreys", 0.5, 100.0), ("nu0", "uniform", 20.0, 80.0),
        ("width", "jeffreys", 0.2, 20.0), ("white", "jeffreys", 0.05, 10.0)]


def _lorentzian_star(pkg, nu, nu0, seed, rows=ROWS, model=None,
                     likelihood="chi22p"):
    """tests/test_ensemble.py::_star in package `pkg` ("jax" | "torch"),
    the spectrum from numpy."""
    name = model or "model_Single_Lorentzian"
    rng = np.random.default_rng(seed)
    p0 = np.array([8.0, nu0 + 1.0, 3.0, 1.2], np.float32)
    spec = rng.exponential(size=nu.shape[0]).astype(np.float32) * 2.0
    if pkg == "jax":
        fn, layout = j_build_model(name)
        pri = JPriors.from_rows(rows if layout.ndim == 4 else
                                [(f"p{i}", "uniform", 0, 1)
                                 for i in range(layout.ndim)])
        return JProblem(model_fn=fn, layout=layout, priors=pri,
                        nu=jnp.asarray(nu), spec=jnp.asarray(spec),
                        params0=jnp.asarray(p0[:layout.ndim] if
                                            layout.ndim <= 4 else
                                            np.zeros(layout.ndim)),
                        likelihood=likelihood,
                        sigma_spec=(jnp.ones_like(jnp.asarray(nu))
                                    if likelihood == "chi_square" else None))
    fn, layout = build_model(name)
    pri = PriorTable.from_rows(rows if layout.ndim == 4 else
                               [(f"p{i}", "uniform", 0, 1)
                                for i in range(layout.ndim)])
    return Problem(model_fn=fn, layout=layout, priors=pri,
                   nu=torch.as_tensor(nu), spec=torch.as_tensor(spec),
                   params0=torch.as_tensor(p0[:layout.ndim] if
                                           layout.ndim <= 4 else
                                           np.zeros(layout.ndim,
                                                    np.float32)),
                   likelihood=likelihood,
                   sigma_spec=(torch.ones(nu.shape[0])
                               if likelihood == "chi_square" else None))


NU = np.linspace(10.0, 90.0, 4096).astype(np.float32)
NU_SHORT = np.linspace(10.0, 90.0, 2048).astype(np.float32)
GAUSS = [("H", "jeffreys", 0.5, 100.0), ("nu0", "gaussian", 50.0, 5.0),
         ("width", "jeffreys", 0.2, 20.0), ("white", "jeffreys", 0.05, 10.0)]


def _pair(case, pkg):
    a = _lorentzian_star(pkg, NU, 40.0, 0)
    if case == "aligned":
        return [a, _lorentzian_star(pkg, NU, 60.0, 1)]
    if case == "different-model":
        return [a, _lorentzian_star(pkg, NU, 60.0, 1,
                                    model="model_Test_Gaussian")]
    if case == "different-prior-kinds":
        return [a, _lorentzian_star(pkg, NU, 60.0, 1, rows=GAUSS)]
    if case == "unaligned-grid":
        return [a, _lorentzian_star(pkg, NU_SHORT, 60.0, 1)]
    if case == "mixed-likelihood":
        return [a, _lorentzian_star(pkg, NU, 60.0, 1,
                                    likelihood="chi_square")]
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "aligned", "different-model", "different-prior-kinds", "unaligned-grid",
    "mixed-likelihood"])
def test_validate_stackable_answers_as_the_reference(case):
    def outcome(validate, problems):
        try:
            validate(problems)
        except ValueError as e:
            return str(e)
        return None
    want = outcome(j_ens.validate_stackable, _pair(case, "jax"))
    got = outcome(ens.validate_stackable, _pair(case, "torch"))
    assert got == want
    assert (want is None) == (case == "aligned")


def _ms_star(nu0_comb, seed, nu_start=1800.0, nu_step=0.1, n_bins=8000):
    """tests/test_ensemble.py::_ms_star (2 orders, l=0, windows anchored at
    the star's own params0) in the reference, its spectrum from numpy."""
    spec_obj = JSpec(n_per_l=(2, 0, 0, 0), n_harvey=1)
    _, layout = j_build_model("model_MS_Global_a1etaa3_HarveyLike", spec_obj)
    p0 = np.zeros(layout.ndim, dtype=np.float64)
    p0[layout.offset("heights"):layout.offset("heights") + 2] = [12.0, 10.0]
    fo = layout.offset("freq_l0")
    p0[fo:fo + 2] = [nu0_comb + 0.5, nu0_comb + 90.5]
    p0[layout.offset("widths"):layout.offset("widths") + 2] = [1.5, 1.5]
    p0[layout.offset("noise"):layout.offset("noise") + 4] = [-1, -1, 2, 0.5]
    p0[layout.offset("trunc")] = 40.0
    hint = (tuple(float(v) for v in p0), float(nu_start), float(nu_step),
            int(n_bins), 10.0)
    spec_win = dataclasses.replace(spec_obj, window_hint=hint)
    fn, layout = j_build_model("model_MS_Global_a1etaa3_HarveyLike",
                               spec_win)
    rows = [("H_0", "jeffreys", 0.5, 100.0), ("H_1", "jeffreys", 0.5, 100.0),
            ("f0_0", "gaussian", float(p0[fo]), 1.0),
            ("f0_1", "gaussian", float(p0[fo + 1]), 1.0),
            ("a1", "fix"), ("eta_sw", "fix"), ("a3", "fix"), ("asym", "fix"),
            ("W_0", "jeffreys", 0.2, 10.0), ("W_1", "jeffreys", 0.2, 10.0),
            ("A1", "fix"), ("B1", "fix"), ("p1", "fix"),
            ("N0", "jeffreys", 0.05, 10.0), ("inc", "fix"), ("trunc", "fix")]
    nu = (nu_start + nu_step * np.arange(n_bins)).astype(np.float32)
    spec = np.random.default_rng(seed).exponential(size=n_bins) + 0.5
    return JProblem(
        model_fn=fn, layout=layout, priors=JPriors.from_rows(rows),
        nu=jnp.asarray(nu), spec=jnp.asarray(spec, jnp.float32),
        params0=jnp.asarray(p0, jnp.float32),
        model_meta={"name": "model_MS_Global_a1etaa3_HarveyLike",
                    "spec": spec_win})


def test_merged_windows_are_the_reference_s():
    """Two stars with combs 400 uHz apart: the port's shared closure cuts
    the grid into the reference's merged segments, one plan for both."""
    ja, jb = _ms_star(2000.0, 0), _ms_star(2400.0, 1)
    j_shared = j_ens._shared_model_problem([ja, jb])
    ta, tb = problem_from_reference(ja), problem_from_reference(jb)
    ens.validate_stackable([ta, tb])
    shared = ens._shared_model_problem([ta, tb])
    assert shared.model_fn._window_groups == \
        j_shared.model_fn._window_groups
    assert shared.model_fn._window_groups != ta.model_fn._window_groups
    assert shared.model_fn._plan.comp_bins() > ta.model_fn._plan.comp_bins()
    # both stars' windows inside the merged ones, and no more
    lo_hi = {(lo, hi) for _, lo, hi in shared.model_fn._window_groups}
    for one in (ta, tb):
        for _, lo, hi in one.model_fn._window_groups:
            assert any(a <= lo and hi <= b for a, b in lo_hi)
    # the multi-star hint built directly gives the same closure
    hint = shared.model_meta["spec"].window_hint
    assert len(hint[0]) == 2
    fn, _ = build_model("model_MS_Global_a1etaa3_HarveyLike",
                        spec=shared.model_meta["spec"])
    assert fn._window_groups == shared.model_fn._window_groups


def _stars(n=2, precision="f32"):
    return [make_demo("ms_global", seed=s, ngrid=2000, n_orders=2,
                      precision=precision)[0] for s in range(n)]


def _close(a, b, what):
    scale = float(b.abs().max()) or 1.0
    assert float((a - b).abs().max()) <= STEP * scale, what


@pytest.mark.parametrize("adapt", [True, False], ids=["adapt", "frozen"])
def test_one_stacked_step_is_each_star_s_step(adapt):
    problems = _stars()
    hp = MALAHyper(dN_chol=1, lambda_temp=1.5)
    T, C = 3, 4
    betas = make_beta_ladder(T, hp.lambda_temp)
    _, stars = ens._per_star_problems(problems)
    stacked = ens.stacked_problem(problems)
    gen = torch.Generator().manual_seed(0)
    singles = [init_state(p, hp, T, C, gen) for p in stars]
    state = ens.stack_states(singles)
    assert state.theta.shape == (2, T, C, stars[0].ndim_free)
    assert state.u_center.shape == (2, stars[0].ndim_free)
    rng = np.random.default_rng(1)
    xi = torch.as_tensor(rng.standard_normal(tuple(state.theta.shape)),
                         dtype=torch.float32)
    u_acc = torch.as_tensor(rng.uniform(size=(2, T, C)), dtype=torch.float32)
    u_swap = torch.as_tensor(rng.uniform(size=(2, T, C)), dtype=torch.float32)
    new = mala_step(stacked, hp, betas, state, adapt=adapt,
                    draws=(xi, u_acc))
    new = tempering_swap(betas, new, 0, u=u_swap)
    rec = make_record(new)
    for s, (p, one) in enumerate(zip(stars, singles)):
        want = mala_step(p, hp, betas, one, adapt=adapt,
                         draws=(xi[s], u_acc[s]))
        want = tempering_swap(betas, want, 0, u=u_swap[s])
        for f in dataclasses.fields(SamplerState):
            got_f, want_f = getattr(new, f.name), getattr(want, f.name)
            if f.name == "step":
                assert got_f == want_f
            else:
                _close(got_f[s], want_f, f"star {s} {f.name}")
        for k, v in make_record(want).items():
            _close(rec[k][s], v, f"star {s} record {k}")
    assert int(new.nswap_att[0].sum()) > 0


def _rel(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("adapt", [True, False], ids=["adapt", "frozen"])
def test_stacked_step_is_the_reference_s(adapt):
    """One stacked step of two reference ms_global stars (2 orders, 2,000
    bins) against the reference ensemble's step: its phase runner's per-star
    step (mala_step, then tempering_swap, on star 0's problem with the star's
    spectrum, hyperparameters and params0) vmapped over the star axis, fed
    the same xi, u_acc and u_swap.  Step 9 -> 10 refreshes the Cholesky
    factor.  Tolerances are those of the single-star parity test
    (tests/test_torch_sampler.py): 1e-5 of each array's max for positions,
    moments, gradients and factors, logL and logP 1e-5 relative, log sigma
    within the adaptation gain (the smoothed acceptance within acc_smooth)
    times four ulp of |logL|; acceptance and swap counts exact."""
    import jax
    from tamcmc_tpu.demos import make_demo as j_make_demo
    from tamcmc_tpu.sampler.mala import default_init_scales
    from tamcmc_tpu.sampler.mala import mala_step as j_mala_step
    from tamcmc_tpu.sampler.state import SamplerState as JState
    from tamcmc_tpu.sampler.tempering import tempering_swap as j_swap
    from tamcmc_tpu_torch import convert

    jps, jhp = [], None
    for seed in (0, 1):
        jp, jhp, _, _ = j_make_demo("ms_global", seed=seed, ngrid=2000,
                                    n_orders=2)
        jps.append(jp)
    j_base, j_stars = j_ens._per_star_problems(jps)
    S, T, C = 2, 3, 10
    rng = np.random.default_rng(5)
    per_star = []
    for js in j_stars:
        Df = js.ndim_free
        u_scale = np.asarray(default_init_scales(js), np.float32)
        u_center = np.asarray(js.extract(js.params0))
        theta = rng.normal(0.0, 0.5, (T, C, Df)).astype(np.float32)
        (logL, logP), (gL, gP) = jax.jit(js.batched_logparts_and_grad)(
            jnp.asarray(u_center + u_scale * theta))
        a = rng.normal(size=(T, C, Df, Df)) / np.sqrt(Df)
        cov = (np.eye(Df) + a @ np.swapaxes(a, -1, -2)).astype(np.float32)
        chol = np.linalg.cholesky(cov.astype(np.float64)).astype(np.float32)
        per_star.append(dict(
            theta=theta, logL=np.asarray(logL), logP=np.asarray(logP),
            gradL=np.asarray(gL) * u_scale, gradP=np.asarray(gP) * u_scale,
            mu=rng.normal(0.0, 0.1, (T, C, Df)).astype(np.float32),
            cov=cov, chol=chol,
            ichol=np.linalg.inv(chol.astype(np.float64)).astype(np.float32),
            log_sigma=rng.normal(0.0, 0.3, (T, C)).astype(np.float32),
            naccept=np.zeros(T, np.float32), nprop=np.asarray(9.0, np.float32),
            acc_rate=rng.uniform(0.3, 0.7, (T, C)).astype(np.float32),
            nswap_att=np.zeros(T, np.float32),
            nswap_acc=np.zeros(T, np.float32),
            scales0=np.ones(Df, np.float32), u_center=u_center,
            u_scale=u_scale))
    arrays = {k: np.stack([a[k] for a in per_star]) for k in per_star[0]}
    xi = rng.standard_normal(arrays["theta"].shape).astype(np.float32)
    u_acc = rng.uniform(size=(S, T, C)).astype(np.float32)
    u_swap = rng.uniform(size=(S, T, C)).astype(np.float32)
    betas = (1.5 ** -np.arange(T)).astype(np.float32)

    def star_step(spec, hyp, p0, state, xi_s, u_acc_s, u_swap_s):
        prob = dataclasses.replace(
            j_base, spec=spec, params0=p0,
            priors=dataclasses.replace(j_base.priors, hypers=hyp))
        key = jax.random.PRNGKey(0)
        state = j_mala_step(prob, jhp, jnp.asarray(betas), state, key,
                            adapt=adapt, draws=(xi_s, u_acc_s))
        return j_swap(jnp.asarray(betas), state, key, 0, u=u_swap_s)

    jstate = JState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                    step=jnp.full(S, 9, jnp.int32))
    jn = jax.jit(jax.vmap(star_step))(
        jnp.stack([p.spec for p in jps]),
        jnp.stack([jnp.asarray(p.priors.hypers, jnp.float32) for p in jps]),
        jnp.stack([p.params0 for p in jps]), jstate, jnp.asarray(xi),
        jnp.asarray(u_acc), jnp.asarray(u_swap))

    tps = [problem_from_reference(p) for p in jps]
    thp = MALAHyper(**dataclasses.asdict(jhp))
    tbetas = torch.as_tensor(betas)
    tn = mala_step(ens.stacked_problem(tps), thp, tbetas,
                   convert.state_from_arrays({**arrays, "step": 9}),
                   adapt=adapt, draws=(torch.as_tensor(xi),
                                       torch.as_tensor(u_acc)))
    tn = tempering_swap(tbetas, tn, 0, u=torch.as_tensor(u_swap))
    got = convert.state_to_arrays(tn)
    want = {f.name: np.asarray(getattr(jn, f.name))
            for f in dataclasses.fields(jn)}
    assert got["step"] == 10 and np.all(want["step"] == 10)
    gamma = jhp.gain_c0 / (jhp.gain_k0 + 10.0) ** jhp.gain_alpha
    for s in range(S):
        # some walkers of the star accepted, some not (naccept starts at 0)
        assert 0 < want["naccept"][s].sum() < T
        for f in ("theta", "mu", "cov", "chol", "ichol", "gradL", "gradP",
                  "u_center", "u_scale"):
            assert _rel(got[f][s], want[f][s]) <= 1e-5, (s, f)
        np.testing.assert_allclose(got["logL"][s], want["logL"][s],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["logP"][s], want["logP"][s],
                                   rtol=1e-5)
        dlog_tol = 4 * np.spacing(np.abs(want["logL"][s]).max())
        assert np.abs(got["log_sigma"][s] - want["log_sigma"][s]).max() \
            <= (gamma * dlog_tol if adapt else 0.0)
        # the smoothed acceptance moves by acc_smooth * min(1, exp(dlog)):
        # the same ulp of dlog, plus one rounding of the float32 update
        assert np.abs(got["acc_rate"][s] - want["acc_rate"][s]).max() \
            <= jhp.acc_smooth * dlog_tol + np.spacing(np.float32(1))
        # the rung's accepted share: a float32 mean over C in another order
        np.testing.assert_allclose(got["naccept"][s], want["naccept"][s],
                                   rtol=1e-6)
        for f in ("nprop", "nswap_att", "nswap_acc"):
            np.testing.assert_array_equal(got[f][s], want[f][s],
                                          err_msg=f"star {s} {f}")
    assert want["nswap_att"].sum() > 0
    if adapt:
        assert np.abs(want["chol"] - arrays["chol"]).max() > 1e-3


def test_stacked_problem_is_each_star_s_posterior():
    """logL, logP and their gradients of the stacked problem, star by star,
    are the star's own (its spectrum, hyperparameters and fixed values)."""
    problems = _stars(3)
    _, stars = ens._per_star_problems(problems)
    stacked = ens.stacked_problem(problems)
    rng = np.random.default_rng(2)
    x0 = torch.stack([p.extract(p.params0) for p in stars])
    x = x0[:, None, None] * (1 + 1e-4 * torch.as_tensor(
        rng.standard_normal((3, 2, 2, x0.shape[-1])), dtype=torch.float32))
    (lL, lP), (gL, gP) = stacked.logparts_and_grad(x)
    assert lL.shape == (3, 2, 2)
    for s, p in enumerate(stars):
        (wL, wP), (wgL, wgP) = p.logparts_and_grad(x[s])
        for a, b, what in ((lL[s], wL, "logL"), (lP[s], wP, "logP"),
                           (gL[s], wgL, "gradL"), (gP[s], wgP, "gradP")):
            _close(a, b, f"star {s} {what}")
    # the stars differ: star 1's data under star 0's walkers give another
    # likelihood
    assert not torch.allclose(lL[0], lL[1])


def test_ensemble_phases_run_with_the_star_axis():
    problems = _stars()
    hp = MALAHyper(lambda_temp=1.5)
    gen = torch.Generator().manual_seed(3)
    states = ens.init_ensemble_state(problems, hp, 2, 4, gen)
    from tamcmc_tpu_torch.sampler.driver import PhasePlan
    plan = PhasePlan(burnin=10, learning=10, acquire=10, thin=5, chunk=2)
    states, results = ens.run_ensemble_phases(
        problems, hp, make_beta_ladder(2, 1.5), states, gen, plan)
    assert results["A"]["theta0"].shape == (2, 2, 4, 16)   # (E, S, C, Df)
    assert results["A"]["logL"].shape == (2, 2, 2, 4)
    assert np.isfinite(results["A"]["logL"]).all()
    assert states.step == 30


def test_stacking_refuses_mixed_precision():
    a, _ = _stars()
    _, b = _stars(precision="bf16")
    with pytest.raises(ValueError, match="profile precision"):
        ens.validate_stackable([a, b])
    # a bf16 stack rebuilds its shared closure in bf16
    shared = ens._shared_model_problem(_stars(precision="bf16"))
    assert shared.model_fn._plan.precision == "bf16"
    with pytest.raises(ValueError, match="different steps"):
        gen = torch.Generator().manual_seed(0)
        hp = MALAHyper()
        s0 = init_state(a, hp, 2, 4, gen)
        ens.stack_states([s0, s0.replace(step=1)])
