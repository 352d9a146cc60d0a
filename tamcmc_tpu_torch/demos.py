"""Built-in demo problem `ms_global` (BASELINE config 3), port of
tamcmc_tpu/demos.py make_demo.

The data are generated from the model itself with chi^2(2 d.o.f.)
multiplicative noise, so posterior recovery of the injected truth validates
the pipeline.  `truth` and `params0` are built with the same numpy draws as
the reference and come out bitwise equal to its demo, so both packages cut
the grid into the same window segments; only the noise draw comes from a
torch.Generator instead of a JAX key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tamcmc_tpu_torch.models.ms_global import MSGlobalSpec, build_ms_global
from tamcmc_tpu_torch.sampler.driver import PhasePlan
from tamcmc_tpu_torch.sampler.mala import default_init_scales
from tamcmc_tpu_torch.sampler.problem import Problem
from tamcmc_tpu_torch.sampler.state import MALAHyper
from tamcmc_tpu_torch.stats.assemblers import build_family_constraints
from tamcmc_tpu_torch.stats.priors import PriorTable

MODEL_NAME = "model_MS_Global_a1etaa3_HarveyLike"


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
    priors = PriorTable.from_rows(rows)
    if priors.ndim != layout.ndim:
        raise AssertionError((priors.ndim, layout.ndim))
    return priors


def make_demo(name: str, seed: int = 0, ngrid: int = None,
              n_orders: int = None, device="cpu"):
    """Returns (problem, hp, plan, meta) on `device`; meta holds the truth.

    ngrid/n_orders scale the demo down (tests); the defaults are the
    production-scale config 3: 6 orders of l = 0, 1, 2 (54 components) on
    a 40,000-bin grid."""
    if name.lower() != "ms_global":
        raise KeyError(f"unknown demo {name!r}; the port has ms_global")
    n_orders = n_orders or 6
    dnu, numax = 100.0, 2500.0
    n_temps, n_chains, ngrid = 6, 6, ngrid or 40_000
    lmax = 2
    plan = PhasePlan(burnin=3000, learning=12000, acquire=15000, thin=5)
    n_per_l = tuple(n_orders if l <= lmax else 0 for l in range(4))
    spec_obj = MSGlobalSpec(n_per_l=n_per_l)
    fn, layout = build_ms_global(spec_obj)

    rng = np.random.default_rng(seed)
    truth, vis_true = _ms_global_truth(layout, n_orders, lmax, dnu, numax,
                                       rng)
    half = dnu * (n_orders / 2 + 1)
    nu = torch.as_tensor(
        np.linspace(numax - half, numax + half, ngrid).astype(np.float32),
        device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        model = fn(torch.as_tensor(truth, dtype=torch.float32, device=device),
                   nu)
        spec = model * torch.empty_like(model).exponential_(generator=gen)

    priors = _ms_global_priors(layout, truth, n_orders, lmax, vis_true)
    p0 = truth.copy()
    # Perturb free params by ~0.3 PRIOR-scale sigmas (never a fraction of
    # the value: that strands frequencies ~100 prior sigmas out)
    free = priors.free_mask
    prob0 = Problem(model_fn=fn, layout=layout, priors=priors, nu=nu,
                    spec=spec, params0=torch.as_tensor(p0, dtype=torch.float32,
                                                       device=device))
    scales = default_init_scales(prob0)                 # (Df,) float32
    p0[free] = p0[free] + 3.0 * scales * rng.standard_normal(free.sum())
    # static truncation windows anchored at p0 (10 uHz margin >> the
    # 5-sigma prior wander of any frequency)
    hint = (tuple(float(v) for v in p0),
            float(numax - half), float(2 * half / (ngrid - 1)),
            int(ngrid), 10.0)
    spec_win = dataclasses.replace(spec_obj, window_hint=hint)
    fn, layout = build_ms_global(spec_win)
    problem = Problem(model_fn=fn, layout=layout, priors=priors, nu=nu,
                      spec=spec,
                      params0=torch.as_tensor(p0, dtype=torch.float32,
                                              device=device),
                      extra_logp=build_family_constraints(MODEL_NAME, layout),
                      model_meta={"name": MODEL_NAME, "spec": spec_win})
    hp = MALAHyper(use_drift=True, dN_mixing=10, lambda_temp=1.5)
    return problem, hp, plan, {"truth": truth, "n_temps": n_temps,
                               "n_chains": n_chains, "model": MODEL_NAME,
                               "spec_kwargs": {"n_per_l": n_per_l}}
