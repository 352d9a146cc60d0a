"""The PyTorch port's RGB asymptotic model (BASELINE config 5) against the
JAX reference in every switch of its spec, the MS_Global width relation,
and the dense models' `fixed` hand-off.

The reference demo `subgiant_mixed` at ngrid=6000 gives the grid and the
parameters; each variant's extra blocks are filled from a seeded numpy
draw.  Tolerances as tests/test_torch_model.py: the full model spectrum
rtol 1e-4, atol 1e-5; gradients rtol 3e-3, atol 3e-4 of the gradient scale.

The RGB model's l=1 frequencies come from a bisection on Dnu and eps_p,
which a least-squares fit forms in float32.  Two compilers may round that
fit differently: an ulp of Dnu, or an ulp of its intercept (eps_p Dnu,
where ~70 uHz cancel), moves the mixed modes by an ulp of frequency, and at
a g-dominated mode a few hundredths of a uHz wide that is ~1e-3 of the
profile.  So each RGB walker is held to the reference, values and gradients
at the tolerances above, at the port's own fit or at a neighbour one ulp of
Dnu and/or one ulp of the intercept away.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.models import build_model as j_build_model
from tamcmc_tpu_torch import convert
from tamcmc_tpu_torch.demos import make_demo as t_make_demo
from tamcmc_tpu_torch.models import asymptotic as t_asymptotic
from tamcmc_tpu_torch.models.ms_global import build_ms_global
from tamcmc_tpu_torch.ops import noise as t_noise

torch.set_num_threads(1)

SPECTRUM = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=3e-3, atol=3e-4)
ULPS = (0, -1, 1)   # fit offsets tried: ulps of Dnu, of its intercept
RGB = "model_RGB_asympt_a1etaa3_HarveyLike"
MS = "model_MS_Global_a1etaa3_HarveyLike"


def _model_parity(name, spec, params, nu, seed):
    """Values and gradients of sum(g * model) of the reference's model_fn
    (vmapped) and the port's (batched) for one spec."""
    jfn, jlayout = j_build_model(name, spec)
    _, tfn, tlayout = convert.build_model(name, dataclasses.asdict(spec))
    assert (tlayout.names, tlayout.sizes) == (jlayout.names, jlayout.sizes)
    g = np.random.default_rng(seed).normal(
        size=(params.shape[0], nu.shape[0])).astype(np.float32)
    jnu = jnp.asarray(nu)
    jmodel = jax.jit(jax.vmap(lambda r: jfn(r, jnu)))
    want = np.asarray(jmodel(jnp.asarray(params)))
    want_g = np.asarray(jax.jit(jax.grad(
        lambda p: jnp.sum(g * jmodel(p))))(jnp.asarray(params)))
    leaf = torch.tensor(params, requires_grad=True)
    out = tfn(leaf, torch.tensor(nu))
    got_g, = torch.autograd.grad(out, leaf, torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), want, **SPECTRUM)
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g.numpy() / scale, want_g / scale, **GRAD)
    return want


def _rgb_parity(spec, params, nu, seed, monkeypatch):
    """_model_parity of the RGB model, each walker at the offsets of its
    Dnu fit in ULPS that best match the reference's spectrum (module
    docstring)."""
    jfn, _ = j_build_model(RGB, spec)
    want = np.asarray(jax.jit(jax.vmap(lambda r: jfn(r, jnp.asarray(nu))))(
        jnp.asarray(params)))
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
    _, tfn, _ = convert.build_model(RGB, dataclasses.asdict(spec))
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
    return _model_parity(RGB, spec, params, nu, seed)


@pytest.fixture(scope="module")
def subgiant():
    jp, _, _, _ = j_make_demo("subgiant_mixed", seed=0, ngrid=6000)
    return jp.model_meta["spec"], np.asarray(jp.params0), np.asarray(jp.nu)


def _variant_params(base_spec, spec, p0, seed, walkers=3):
    """The demo's params0 moved into `spec`'s layout, every walker a small
    seeded perturbation; per-mode tables and the width relation drawn."""
    rng = np.random.default_rng(seed)
    bl, vl = base_spec.layout(), spec.layout()
    out = np.zeros((walkers, vl.ndim), np.float32)
    for name in vl.names:
        o, n = vl.offset(name), vl.size(name)
        if name == "widths" and spec.width_kind == "app2016":
            # numax, alpha, Gamma_alpha, dGamma_dip, nu_dip, W_dip
            v = np.asarray([130.0, 3.0, 0.15, 1.5, 128.0, 180.0])
        elif name in ("mix_hfact", "mix_wfact"):
            v = 1.0 + 0.2 * rng.standard_normal(n)
        elif name == "mix_fshift":
            v = 0.02 * rng.standard_normal(n)
        else:
            v = p0[bl.offset(name):bl.offset(name) + n]
        out[:, o:o + n] = v
    for name, sd in (("freq_l0", 0.01), ("freq_l2", 0.01), ("heights", 0.05)):
        o, n = vl.offset(name), vl.size(name)
        out[:, o:o + n] += sd * rng.standard_normal((walkers, n))
    mo = vl.offset("mixed")
    out[:, mo:mo + 3] += [0.2, 0.01, 0.005] * rng.standard_normal((walkers, 3))
    return out


@pytest.mark.parametrize("variant", [
    dict(),
    dict(height_kind="inertia"),
    dict(per_mode="hw"),
    dict(per_mode="hw_scatter"),
    dict(height_kind="inertia", per_mode="hw_scatter"),
    dict(width_kind="app2016"),
    dict(noise_kind="harvey_1985"),
])
def test_rgb_model_matches_jax(subgiant, variant, monkeypatch):
    base, p0, nu = subgiant
    spec = dataclasses.replace(base, **variant)
    params = _variant_params(base, spec, p0, seed=len(str(variant)))
    if spec.noise_kind == "harvey_1985":        # tc-style second entries
        no = spec.layout().offset("noise")
        params[:, no + 1] = 0.3
    want = _rgb_parity(spec, params, nu, 7, monkeypatch)
    assert np.all(np.isfinite(want))


def test_rgb_o2_terms_match_jax(subgiant, monkeypatch):
    """delta0l, alpha_p and alpha_g free in the model, through the solver."""
    base, p0, nu = subgiant
    params = _variant_params(base, base, p0, seed=11)
    mo = base.layout().offset("mixed")
    params[:, mo + 3:mo + 6] = [0.3, 0.01, 1e-3]
    _rgb_parity(base, params, nu, 12, monkeypatch)


def test_ms_global_app2016_matches_jax():
    """MS_Global with the Appourchaux+2016 width relation, dense and with
    static window segments."""
    jp, _, _, _ = j_make_demo("ms_global", seed=0, ngrid=3000, n_orders=3)
    base = jp.model_meta["spec"]
    p0 = np.asarray(jp.params0)
    nu = np.asarray(jp.nu)
    for hint in (None, base.window_hint):
        spec = dataclasses.replace(base, width_kind="app2016",
                                   window_hint=None)
        lay = spec.layout()
        params = np.zeros((2, lay.ndim), np.float32)
        bl = base.layout()
        for name in lay.names:
            o, n = lay.offset(name), lay.size(name)
            params[:, o:o + n] = (
                [2500.0, 3.5, 1.5, 2.0, 2450.0, 2900.0] if name == "widths"
                else p0[bl.offset(name):bl.offset(name) + n])
        if hint is not None:
            # the segments are anchored at this params0
            spec = dataclasses.replace(
                spec, window_hint=(tuple(float(v) for v in params[0]),)
                + hint[1:])
        params[1, lay.offset("freq_l0")] += 0.05
        _model_parity(MS, spec, params, nu, seed=13)


def _dense_problems():
    """Dense ms_global (the demo without its window hint) and subgiant_mixed
    at small grids."""
    ms, _, _, _ = t_make_demo("ms_global", seed=0, ngrid=2000, n_orders=2)
    spec = dataclasses.replace(ms.model_meta["spec"], window_hint=None)
    ms = dataclasses.replace(ms, model_fn=build_ms_global(spec)[0],
                             model_meta={"name": MS, "spec": spec})
    sg, _, _, _ = t_make_demo("subgiant_mixed", seed=0, ngrid=3000)
    return {"ms_global_dense": ms, "subgiant_mixed": sg}


@pytest.mark.parametrize("which", ["ms_global_dense", "subgiant_mixed"])
def test_dense_path_hands_fixed_terms_to_the_model(which, monkeypatch):
    """Problem hands the dense model_fn (params0, fixed mask): logL and its
    gradient are those of the per-walker evaluation within 1e-6 relative,
    and the all-fixed Harvey terms are evaluated once, unbatched and
    outside autograd."""
    problem = _dense_problems()[which]
    assert problem._pieces_hook is None

    def per_walker_fn(params, nu, fixed=None):
        return problem.model_fn(params, nu)

    per_walker = dataclasses.replace(problem, model_fn=per_walker_fn)
    rng = np.random.default_rng(3)
    x0 = problem.extract(problem.params0).numpy()
    x = torch.as_tensor(x0 + 1e-4 * np.abs(x0) * rng.standard_normal(
        (2, 3, x0.shape[0])), dtype=torch.float32)

    calls = []
    harvey_like = t_noise.harvey_like

    def spy(nu, A, B, p):
        out = harvey_like(nu, A, B, p)
        calls.append((tuple(out.shape), out.requires_grad))
        return out

    monkeypatch.setattr(t_noise, "harvey_like", spy)
    runs = {}
    for label, prob in (("handed", problem), ("per_walker", per_walker)):
        calls.clear()
        (logL, _), (gradL, _) = prob.logparts_and_grad(x)
        runs[label] = (logL.numpy(), gradL.numpy(), list(calls))
    (l1, g1, c1), (l0, g0, c0) = runs["handed"], runs["per_walker"]
    n = problem.nu.shape[0]
    # the demo fixes every Harvey A, B, p (N0 is free): three unbatched
    # terms without gradient, against three batched ones in autograd
    assert c1 == [((n,), False)] * 3
    assert c0 == [((2, 3, n), True)] * 3
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    scale = np.abs(g0).max()
    np.testing.assert_allclose(g1 / scale, g0 / scale, rtol=0, atol=1e-6)
