"""Built-in demo problems, the BASELINE config ladder (port of
tamcmc_tpu/demos.py make_demo):

  single_lorentzian       config 1: one Lorentzian + white noise
  harvey_background       config 2: smoothed spectrum, chi_square likelihood
  ms_global               config 3: l = 0, 1, 2 with a1 + inclination
  kepler_full             config 4: 14 orders of l = 0..3, 10 temperatures
  subgiant_mixed          config 5: dense l = 1 mixed modes (ARMM solver)
  subgiant_mixed_inertia  config 5 with the mode-inertia height switch
  ajfit                   a-coefficient table fit (no spectrum, no kernel)

The data are generated from the model itself (chi^2 2-d.o.f. multiplicative
noise for raw periodograms, Gaussian noise for the smoothed spectrum), so
posterior recovery of the injected truth validates the pipeline.  `truth`
and `params0` are built with the reference's numpy draws and come out
bitwise equal to its demos, so both packages cut the grid into the same
window segments; only the noise draw comes from a torch.Generator instead of
a JAX key.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tamcmc_tpu_torch.models.ajfit import AjFitSpec, build_ajfit
from tamcmc_tpu_torch.models.asymptotic import RGBAsymptSpec, build_rgb_asympt
from tamcmc_tpu_torch.models.ms_global import MSGlobalSpec, build_ms_global
from tamcmc_tpu_torch.models.test_models import (
    HarveyBackgroundSpec, SingleLorentzianSpec, build_harvey_background,
    build_single_lorentzian)
from tamcmc_tpu_torch.ops.armm import count_poles
from tamcmc_tpu_torch.sampler.driver import PhasePlan
from tamcmc_tpu_torch.sampler.mala import default_init_scales
from tamcmc_tpu_torch.sampler.problem import Problem
from tamcmc_tpu_torch.sampler.state import MALAHyper
from tamcmc_tpu_torch.stats.assemblers import build_family_constraints
from tamcmc_tpu_torch.stats.priors import PriorTable

MS_GLOBAL = "model_MS_Global_a1etaa3_HarveyLike"
RGB_ASYMPT = "model_RGB_asympt_a1etaa3_HarveyLike"
SINGLE_LORENTZIAN = "model_Single_Lorentzian"
HARVEY_BACKGROUND = "model_Harvey_Background"
AJFIT = "model_ajfit"


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _grid(lo, hi, n, device):
    """(float64 linspace, its float32 cast on `device`): the fit sees the
    second, `make-example` writes the first, which reads back to it."""
    nu64 = np.linspace(lo, hi, n)
    return nu64, _f32(nu64, device)


def _model(fn, truth, nu):
    with torch.no_grad():
        return fn(_f32(truth, nu.device), nu)


def _chi2_noise(model, gen):
    """Raw periodogram: the model times chi^2(2 d.o.f.)/2 noise."""
    return model * torch.empty_like(model).exponential_(generator=gen)


def _problem(name, fn, layout, priors, nu, spec, p0, spec_obj,
             precision="f32", **kw):
    if priors.ndim != layout.ndim:
        raise AssertionError((priors.ndim, layout.ndim))
    return Problem(model_fn=fn, layout=layout, priors=priors, nu=nu,
                   spec=spec, params0=_f32(p0, nu.device),
                   extra_logp=build_family_constraints(name, layout),
                   model_meta={"name": name, "spec": spec_obj,
                               "precision": precision}, **kw)


def _meta(truth, n_temps, n_chains, name, spec_kwargs, nu64):
    return {"truth": truth, "n_temps": n_temps, "n_chains": n_chains,
            "model": name, "spec_kwargs": spec_kwargs, "nu64": nu64}


def _single_lorentzian(seed, ngrid, n_orders, device, gen, precision):
    spec_obj = SingleLorentzianSpec()
    fn, layout = build_single_lorentzian(spec_obj)
    nu64, nu = _grid(10.0, 90.0, 8192, device)
    truth = np.asarray([12.0, 50.0, 2.0, 1.0], np.float32)
    spec = _chi2_noise(_model(fn, truth, nu), gen)
    priors = PriorTable.from_rows([
        ("H", "jeffreys", 0.5, 100.0),
        ("nu0", "uniform", 30.0, 70.0),
        ("width", "jeffreys", 0.2, 20.0),
        ("white", "jeffreys", 0.05, 10.0),
    ])
    p0 = np.asarray([8.0, 48.0, 3.0, 1.5])
    problem = _problem(SINGLE_LORENTZIAN, fn, layout, priors, nu, spec, p0,
                       None)
    return (problem, MALAHyper(use_drift=True, dN_mixing=10, lambda_temp=1.6),
            PhasePlan(burnin=1000, learning=4000, acquire=8000, thin=4),
            _meta(truth, 4, 8, SINGLE_LORENTZIAN, {}, nu64))


def _harvey_background(seed, ngrid, n_orders, device, gen, precision):
    spec_obj = HarveyBackgroundSpec()
    fn, layout = build_harvey_background(spec_obj)
    nu64, nu = _grid(1.0, 4000.0, 16384, device)
    truth = np.asarray([300.0, 0.02, 4.0, 50.0, 0.004, 4.0,
                        10.0, 0.0008, 2.0, 0.3], np.float32)
    model = _model(fn, truth, nu)
    nsmooth = 50
    sigma = model / math.sqrt(nsmooth)
    spec = model + sigma * torch.randn(model.shape, generator=gen,
                                       device=device)
    priors = PriorTable.from_rows([
        ("A1", "jeffreys", 10.0, 3000.0), ("B1", "jeffreys", 1e-3, 1.0),
        ("p1", "uniform", 1.0, 6.0),
        ("A2", "jeffreys", 1.0, 500.0), ("B2", "jeffreys", 1e-4, 0.1),
        ("p2", "uniform", 1.0, 6.0),
        ("A3", "jeffreys", 0.5, 100.0), ("B3", "jeffreys", 1e-5, 0.01),
        ("p3", "uniform", 1.0, 6.0),
        ("N0", "jeffreys", 0.01, 10.0),
    ])
    p0 = truth * (1 + 0.3 * np.random.default_rng(seed).standard_normal(10))
    p0 = np.clip(p0, [10, 1e-3, 1.0, 1, 1e-4, 1.0, 0.5, 1e-5, 1.0, 0.01],
                 [3000, 1.0, 6.0, 500, 0.1, 6.0, 100, 0.01, 6.0, 10.0])
    problem = _problem(HARVEY_BACKGROUND, fn, layout, priors, nu, spec, p0,
                       None, likelihood="chi_square", sigma_spec=sigma)
    return (problem, MALAHyper(use_drift=True, dN_mixing=10, lambda_temp=1.6),
            PhasePlan(burnin=2000, learning=6000, acquire=8000, thin=4),
            _meta(truth, 4, 8, HARVEY_BACKGROUND, {}, nu64))


def _ms_global_truth(layout, n_orders, lmax, dnu, numax, rng):
    f0 = numax + dnu * (np.arange(n_orders) - n_orders / 2) \
        + rng.normal(0, 0.5, n_orders)
    f0.sort()
    envelope = np.exp(-0.5 * ((f0 - numax) / (0.18 * numax)) ** 2)
    heights = 8.0 * envelope + 0.5
    widths = 1.0 + 2.0 * (f0 - f0[0]) / (f0[-1] - f0[0])
    vis_true = [1.5, 0.53, 0.07][:max(lmax, 1)]
    truth = np.zeros(layout.ndim)
    ho = layout.offset("heights")
    truth[ho:ho + n_orders] = heights
    vo = layout.offset("visibilities")
    truth[vo:vo + len(vis_true)] = vis_true
    for l in range(lmax + 1):
        off = {0: 0.0, 1: dnu / 2, 2: -0.12 * dnu, 3: 0.28 * dnu}[l]
        o = layout.offset(f"freq_l{l}")
        truth[o:o + n_orders] = f0 + off
    ro = layout.offset("rot")
    truth[ro:ro + 4] = [1.2, 1.0, 0.01, 0.0]   # a1, eta_sw, a3, asym
    wo = layout.offset("widths")
    truth[wo:wo + n_orders] = widths
    no = layout.offset("noise")
    truth[no:no + 10] = [50.0, 2e-3, 4.0, 10.0, 4e-4, 2.0, -1, -1, 2.0, 0.2]
    truth[layout.offset("inclination")] = np.deg2rad(55.0)
    truth[layout.offset("trunc")] = 40.0
    return truth, vis_true


def _ms_global_priors(layout, truth, n_orders, lmax, vis_true):
    rows = [(f"H_{i}", "jeffreys", 0.2, 100.0) for i in range(n_orders)]
    for l in range(1, lmax + 1):
        rows.append((f"V2_{l}", "gaussian", vis_true[l - 1], 0.1))
    if lmax < 1:
        rows.append(("V2_pad", "fix"))
    for l in range(4):
        o = layout.offset(f"freq_l{l}")
        for i in range(layout.size(f"freq_l{l}")):
            rows.append((f"f{l}_{i}", "gaussian", float(truth[o + i]), 1.0))
    rows += [("a1", "uniform", 0.0, 8.0), ("eta_sw", "fix"),
             ("a3", "gaussian", 0.0, 0.1), ("asym", "fix")]
    rows += [(f"W_{i}", "jeffreys", 0.3, 15.0) for i in range(n_orders)]
    rows += [("An1", "fix"), ("Bn1", "fix"), ("pn1", "fix"),
             ("An2", "fix"), ("Bn2", "fix"), ("pn2", "fix"),
             ("An3", "fix"), ("Bn3", "fix"), ("pn3", "fix"),
             ("N0", "jeffreys", 0.02, 5.0),
             ("inc", "uniform", 0.0, np.pi / 2),
             ("trunc", "fix")]
    return PriorTable.from_rows(rows)


# (n_orders, dnu, numax, n_temps, ngrid, lmax, plan, lambda_temp)
_MS_GLOBAL_CONFIGS = {
    "ms_global": (6, 100.0, 2500.0, 6, 40_000, 2,
                  PhasePlan(burnin=3000, learning=12000, acquire=15000,
                            thin=5), 1.5),
    "kepler_full": (14, 85.0, 2200.0, 10, 120_000, 3,
                    PhasePlan(burnin=4000, learning=20000, acquire=25000,
                              thin=5), 1.35),
}


def _ms_global_family(name, seed, ngrid, n_orders, device, gen, precision):
    """configs 3 and 4: MS_Global a1etaa3 with static window segments
    anchored at params0."""
    (n_def, dnu, numax, n_temps, ngrid_def, lmax, plan,
     lambda_temp) = _MS_GLOBAL_CONFIGS[name]
    n_orders = n_orders or n_def
    ngrid = ngrid or ngrid_def
    n_per_l = tuple(n_orders if l <= lmax else 0 for l in range(4))
    spec_obj = MSGlobalSpec(n_per_l=n_per_l)
    fn, layout = build_ms_global(spec_obj, precision)

    rng = np.random.default_rng(seed)
    truth, vis_true = _ms_global_truth(layout, n_orders, lmax, dnu, numax,
                                       rng)
    half = dnu * (n_orders / 2 + 1)
    nu64, nu = _grid(numax - half, numax + half, ngrid, device)
    spec = _chi2_noise(_model(fn, truth, nu), gen)

    priors = _ms_global_priors(layout, truth, n_orders, lmax, vis_true)
    p0 = truth.copy()
    # Perturb free params by ~0.3 PRIOR-scale sigmas (never a fraction of
    # the value: that strands frequencies ~100 prior sigmas out)
    free = priors.free_mask
    prob0 = Problem(model_fn=fn, layout=layout, priors=priors, nu=nu,
                    spec=spec, params0=_f32(p0, device))
    scales = default_init_scales(prob0)                 # (Df,) float32
    p0[free] = p0[free] + 3.0 * scales * rng.standard_normal(free.sum())
    # static truncation windows anchored at p0 (10 uHz margin >> the
    # 5-sigma prior wander of any frequency)
    hint = (tuple(float(v) for v in p0),
            float(numax - half), float(2 * half / (ngrid - 1)),
            int(ngrid), 10.0)
    spec_win = dataclasses.replace(spec_obj, window_hint=hint)
    fn, layout = build_ms_global(spec_win, precision)
    problem = _problem(MS_GLOBAL, fn, layout, priors, nu, spec, p0, spec_win,
                       precision)
    hp = MALAHyper(use_drift=True, dN_mixing=10, lambda_temp=lambda_temp)
    return problem, hp, plan, _meta(truth, n_temps, 6, MS_GLOBAL,
                                    {"n_per_l": n_per_l}, nu64)


def _subgiant_mixed(name, seed, ngrid, n_orders, device, gen, precision):
    """config 5: l=0/2 p modes fitted individually, the l=1 mixed-mode
    forest from the ARMM solver; `_inertia` turns on the mode-inertia
    height suppression."""
    height_kind = ("inertia" if name.endswith("_inertia")
                   else "equipartition")
    dnu, dpi1, eps_g, qq = 10.0, 80.0, 0.0, 0.15
    numin, numax_w = 100.0, 160.0
    n_orders = n_orders or 5
    n_p, n_g = count_poles(dnu, dpi1, 0.4, eps_g, numin, numax_w)
    spec_obj = RGBAsymptSpec(n_orders=n_orders, numin=numin,
                             numax_win=numax_w, n_p_poles=n_p,
                             n_g_poles=n_g, height_kind=height_kind)
    fn, layout = build_rgb_asympt(spec_obj, precision)
    truth = np.zeros(layout.ndim)
    f0 = 100.0 + dnu * (np.arange(n_orders) + 0.4)
    ho = layout.offset("heights")
    truth[ho:ho + n_orders] = 6.0
    vo = layout.offset("visibilities")
    truth[vo:vo + 2] = [1.5, 0.53]
    o0, o2 = layout.offset("freq_l0"), layout.offset("freq_l2")
    truth[o0:o0 + n_orders] = f0
    truth[o2:o2 + n_orders] = f0 - 1.2
    # O(2) terms (delta0l, alpha_p, alpha_g) zero: first-order truth
    mo = layout.offset("mixed")
    truth[mo:mo + 6] = [dpi1, eps_g, qq, 0.0, 0.0, 0.0]
    ro = layout.offset("rot")
    truth[ro:ro + 3] = [0.05, 0.4, 0.0]
    wo = layout.offset("widths")
    truth[wo:wo + n_orders] = 0.15
    no = layout.offset("noise")
    truth[no:no + 10] = [20.0, 0.05, 2.0, -1, -1, 2, -1, -1, 2, 0.1]
    truth[layout.offset("inclination")] = np.deg2rad(60.0)
    nu64, nu = _grid(numin, numax_w, ngrid or 60_000, device)
    spec = _chi2_noise(_model(fn, truth, nu), gen)
    rows = [(f"H_{i}", "jeffreys", 0.2, 100.0) for i in range(n_orders)]
    rows += [("V2_1", "gaussian", 1.5, 0.1), ("V2_2", "gaussian", 0.53, 0.08)]
    rows += [(f"f0_{i}", "gaussian", float(f0[i]), 0.3)
             for i in range(n_orders)]
    rows += [(f"f2_{i}", "gaussian", float(f0[i] - 1.2), 0.3)
             for i in range(n_orders)]
    rows += [("DPi1", "uniform", 60.0, 100.0),
             ("eps_g", "uniform", -0.5, 0.5),
             ("q", "uniform", 0.02, 0.5),
             ("delta0l", "fix"), ("alpha_p", "fix"), ("alpha_g", "fix"),
             ("a1_env", "uniform", 0.0, 0.5),
             ("a1_core", "uniform", 0.0, 1.5),
             ("asym", "fix")]
    rows += [(f"W_{i}", "jeffreys", 0.02, 2.0) for i in range(n_orders)]
    rows += [("An1", "fix"), ("Bn1", "fix"), ("pn1", "fix"),
             ("An2", "fix"), ("Bn2", "fix"), ("pn2", "fix"),
             ("An3", "fix"), ("Bn3", "fix"), ("pn3", "fix"),
             ("N0", "jeffreys", 0.01, 2.0),
             ("inc", "uniform", 0.0, np.pi / 2),
             ("trunc", "fix")]
    priors = PriorTable.from_rows(rows)
    rng = np.random.default_rng(seed)
    p0 = truth.copy()
    free = priors.free_mask
    p0[free] *= (1 + 0.01 * rng.standard_normal(free.sum()))
    problem = _problem(RGB_ASYMPT, fn, layout, priors, nu, spec, p0,
                       spec_obj, precision)
    hp = MALAHyper(use_drift=True, dN_mixing=10, lambda_temp=1.3)
    plan = PhasePlan(burnin=4000, learning=15000, acquire=20000, thin=5)
    return problem, hp, plan, _meta(truth, 8, 6, RGB_ASYMPT, {
        "n_orders": n_orders, "numin": numin, "numax_win": numax_w,
        "n_p_poles": n_p, "n_g_poles": n_g, "height_kind": height_kind},
        nu64)


def _ajfit(seed, ngrid, n_orders, device, gen, precision):
    """a-coefficient table fit (io_ajfit [U]): 3 l=1 + 3 l=2 multiplets
    around numax, truth aj plus a gate-filter activity band; the data are
    nu_nlm with Gaussian noise, chi_square likelihood over the table."""
    ls = (1, 1, 1, 2, 2, 2)
    spec_obj = AjFitSpec(l_per_multiplet=ls)
    fn, layout = build_ajfit(spec_obj)
    rng = np.random.default_rng(seed)
    dnu = 100.0
    nu_nl = 2200.0 + dnu * np.arange(6) + rng.normal(0, 0.3, 6)
    nu_nl[3:] -= 0.12 * dnu + 250.0          # l=2 ridge offset
    nu_nl.sort()
    truth = np.zeros(layout.ndim)
    truth[layout.offset("nu_nl"):layout.offset("nu_nl") + 6] = nu_nl
    ao = layout.offset("aj")
    truth[ao:ao + 6] = [0.40, 0.030, 0.015, 0.004, 0.002, 0.001]
    aco = layout.offset("activity")
    truth[aco:aco + 3] = [5e-4, np.deg2rad(20.0), np.deg2rad(15.0)]
    n_pts = spec_obj.n_points
    sigma = _f32(np.full(n_pts, 0.03), device)
    nu_idx = torch.arange(n_pts, dtype=torch.float32, device=device)
    model = _model(fn, truth, nu_idx)
    spec = model + sigma * torch.randn(model.shape, generator=gen,
                                       device=device)
    rows = [(f"nu_{i}", "gaussian", float(nu_nl[i]), 0.5) for i in range(6)]
    rows += [("a1", "uniform", 0.0, 2.0),
             ("a2", "gaussian", 0.0, 0.2),
             ("a3", "gaussian", 0.0, 0.2),
             ("a4", "gaussian", 0.0, 0.05),
             ("a5", "gaussian", 0.0, 0.05),
             ("a6", "gaussian", 0.0, 0.05),
             ("epsilon", "uniform", 0.0, 5e-3),
             ("theta0", "uniform", 0.0, np.pi / 2),
             ("delta", "uniform", np.deg2rad(2.0), np.deg2rad(45.0))]
    priors = PriorTable.from_rows(rows)
    p0 = truth.copy()
    p0[6:12] = [0.3, 0.0, 0.0, 0.0, 0.0, 0.0]
    p0[12:15] = [1e-3, np.deg2rad(30.0), np.deg2rad(10.0)]
    problem = _problem(AJFIT, fn, layout, priors, nu_idx, spec, p0, spec_obj,
                       likelihood="chi_square", sigma_spec=sigma)
    return (problem, MALAHyper(use_drift=True, dN_mixing=10, lambda_temp=1.6),
            PhasePlan(burnin=1500, learning=5000, acquire=8000, thin=4),
            _meta(truth, 4, 8, AJFIT, {"l_per_multiplet": ls},
                  np.arange(n_pts, dtype=np.float64)))


DEMOS = {
    "single_lorentzian": _single_lorentzian,
    "harvey_background": _harvey_background,
    "ms_global": lambda *a: _ms_global_family("ms_global", *a),
    "kepler_full": lambda *a: _ms_global_family("kepler_full", *a),
    "subgiant_mixed": lambda *a: _subgiant_mixed("subgiant_mixed", *a),
    "subgiant_mixed_inertia":
        lambda *a: _subgiant_mixed("subgiant_mixed_inertia", *a),
    "ajfit": _ajfit,
}


def make_demo(name: str, seed: int = 0, ngrid: int = None,
              n_orders: int = None, device="cpu", precision: str = "f32"):
    """Returns (problem, hp, plan, meta) on `device`; meta holds the truth.

    ngrid/n_orders scale the MS_Global and subgiant demos down (tests); the
    defaults are the production-scale configs.  `precision` is the
    Lorentzian profile stream of every model the demo builds, the one that
    draws its spectrum included, as the reference's demos do under
    set_profile_precision."""
    name = name.lower()
    if name not in DEMOS:
        raise KeyError(f"unknown demo {name!r}; have {', '.join(DEMOS)}")
    gen = torch.Generator(device=device).manual_seed(seed)
    return DEMOS[name](seed, ngrid, n_orders, torch.device(device), gen,
                       precision)
