"""Aligned-grid multi-star ensemble: one tempered sampler over S stars.

Port of tamcmc_tpu/sampler/ensemble.py.  S problems sharing one model
family, layout, prior kinds, likelihood and frequency grid (only the
observed spectra, prior hyperparameters and initial/fixed values differ) are
advanced by one step whose tensors lead with a star axis: the state is
(S, T, C, ...), and the per-star data are stacked as (S, 1, 1, ...) so that
they broadcast against the walkers (`stacked_problem`).  The model closure
is one for all stars (`_shared_model_problem`), so on a CUDA device the
Lorentzian kernels see Bt = S*T*C walkers: one step of S stars makes the
launches of one step of one star.  `mala_step`, `tempering_swap` and
`make_record` take the leading axis; walker moments reduce over C, swaps
pair temperatures inside a star.

The reference vmaps its step over stars with a key per star; here one
torch.Generator draws every star's numbers at once, as it draws every
walker's in a single-star run, and its state at a chunk's end is the
continuation a checkpoint keeps.

For stars whose grids do NOT align, use the serial `batch` workflow.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tamcmc_tpu_torch.sampler.driver import PhasePlan, run_phase
from tamcmc_tpu_torch.sampler.mala import init_state
from tamcmc_tpu_torch.sampler.problem import Problem
from tamcmc_tpu_torch.sampler.state import MALAHyper, SamplerState
from tamcmc_tpu_torch.stats.priors import PriorTable


def _spec_sans_window(spec):
    if spec is not None and hasattr(spec, "window_hint"):
        return dataclasses.replace(spec, window_hint=None)
    return spec


def _model_meta(p):
    """Problem.model_meta, falling back to the introspection attributes
    build_model stamps on every registry closure."""
    if p.model_meta is not None:
        return p.model_meta
    name = getattr(p.model_fn, "_family_name", None)
    if name is None:
        return None
    return {"name": name, "spec": getattr(p.model_fn, "_family_spec", None),
            "precision": getattr(p.model_fn, "_precision", "f32")}


def _host(a):
    return np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)


def validate_stackable(problems):
    """All problems must share the static structure; returns nothing, raises
    ValueError with the offending star index otherwise.  A silently mixed
    ensemble would sample every star against star 0's model.

    Model identity: the stacked step evaluates ONE model closure for all
    stars, so stars must verifiably share the model family.  Distinct
    closure objects are accepted only when both carry `model_meta` with the
    same family name and the same spec (window hints aside: those are
    merged by _shared_model_problem); a bare closure that differs from star
    0's is rejected rather than silently evaluated with star 0's model."""
    base = problems[0]
    meta0 = _model_meta(base)
    for i, p in enumerate(problems[1:], start=1):
        if p.layout.ndim != base.layout.ndim:
            raise ValueError(f"star {i}: layout ndim {p.layout.ndim} != "
                             f"{base.layout.ndim}")
        if p.model_fn is not base.model_fn:
            meta_i = _model_meta(p)
            if meta0 is None or meta_i is None:
                raise ValueError(
                    f"star {i}: model closure differs from star 0 and "
                    "model_meta is missing — cannot prove the stars share a "
                    "model family; build problems via build_model/the CLI "
                    "(which stamp family metadata) or share one model_fn")
            if meta_i["name"] != meta0["name"]:
                raise ValueError(f"star {i}: model family "
                                 f"{meta_i['name']!r} != {meta0['name']!r}")
            if _spec_sans_window(meta_i.get("spec")) != \
                    _spec_sans_window(meta0.get("spec")):
                raise ValueError(f"star {i}: model spec differs from star 0 "
                                 "(beyond window hints)")
            if meta_i.get("precision", "f32") != meta0.get("precision",
                                                           "f32"):
                raise ValueError(f"star {i}: profile precision "
                                 f"{meta_i.get('precision', 'f32')!r} != "
                                 f"{meta0.get('precision', 'f32')!r}")
        if not np.array_equal(np.asarray(p.priors.kinds),
                              np.asarray(base.priors.kinds)):
            raise ValueError(f"star {i}: prior kinds differ")
        if p.likelihood != base.likelihood:
            raise ValueError(f"star {i}: likelihood {p.likelihood!r} != "
                             f"{base.likelihood!r}")
        if p.nu.shape != base.nu.shape or \
                not np.allclose(_host(p.nu), _host(base.nu)):
            raise ValueError(f"star {i}: frequency grid not aligned")
        if (p.mask is None) != (base.mask is None):
            raise ValueError(f"star {i}: mask presence differs")
        if (p.sigma_spec is None) != (base.sigma_spec is None):
            raise ValueError(f"star {i}: sigma_spec presence differs")


def _shared_model_problem(problems):
    """Star 0's problem, with the model closure rebuilt so it is correct for
    every star.

    The only per-star constants a model closure bakes in are the static
    truncation window segments (anchored at each star's params0,
    models/ms_global.py).  If any star uses them, one closure is rebuilt
    whose windows are the per-component union across stars (conservative,
    hence correct for all): one segment plan, one LorentzPlan for every
    star.  With no windows anywhere, star 0's closure already serves every
    star."""
    base = problems[0]
    hints = []
    for p in problems:
        spec = (_model_meta(p) or {}).get("spec")
        hints.append(getattr(spec, "window_hint", None) if spec is not None
                     else None)
    if not any(h is not None for h in hints):
        return base
    with_hints = [h for h in hints if h is not None]
    grid0 = with_hints[0][1:4]
    for h in with_hints[1:]:
        if h[1:4] != grid0:
            raise ValueError("window hints disagree on the grid; grids were "
                             "validated aligned — rebuild the problems")
    merged = (tuple(tuple(h[0]) for h in with_hints), grid0[0], grid0[1],
              grid0[2], max(h[4] for h in with_hints))
    from tamcmc_tpu_torch.models import build_model
    meta = _model_meta(base)
    spec = dataclasses.replace(meta["spec"], window_hint=merged)
    fn, _ = build_model(meta["name"], spec=spec,
                        precision=meta.get("precision", "f32"))
    return dataclasses.replace(base, model_fn=fn,
                               model_meta={**meta, "spec": spec})


def _per_star_problems(problems):
    """(shared_base, per-star problems): every star rebuilt around the ONE
    ensemble-safe model closure (see _shared_model_problem), differing only
    in its per-star data fields."""
    validate_stackable(problems)
    base = _shared_model_problem(problems)
    stars = [dataclasses.replace(
        base, spec=p.spec, priors=p.priors, params0=p.params0,
        sigma_spec=p.sigma_spec, mask=p.mask) for p in problems]
    return base, stars


def stacked_problem(problems) -> Problem:
    """The whole ensemble as one Problem over (S, T, C, Df) walkers: the
    shared model closure, the per-star spec, params0, sigma_spec and mask
    stacked as (S, 1, 1, ...), the prior hyperparameters as (S, 1, 1, D, 4).
    Fixed parameters embed from each star's own params0, and the all-fixed
    Harvey terms are evaluated once per star (ops/noise.py)."""
    base, stars = _per_star_problems(problems)

    def stack(field):
        if getattr(base, field) is None:
            return None
        return torch.stack([getattr(p, field) for p in stars])[:, None, None]

    hypers = np.stack([np.asarray(p.priors.hypers) for p in stars])
    priors = PriorTable(base.priors.kinds, hypers[:, None, None],
                        base.priors.names)
    return dataclasses.replace(
        base, spec=stack("spec"), params0=stack("params0"),
        sigma_spec=stack("sigma_spec"), mask=stack("mask"), priors=priors)


def stack_states(states) -> SamplerState:
    """Per-star SamplerStates (one step counter) as one with a leading star
    axis; each tensor row-major, as every state is kept."""
    steps = {s.step for s in states}
    if len(steps) != 1:
        raise ValueError(f"the stars' states are at different steps {steps}")
    return SamplerState(**{
        f.name: (states[0].step if f.name == "step" else torch.stack(
            [getattr(s, f.name) for s in states]).contiguous())
        for f in dataclasses.fields(SamplerState)})


def init_ensemble_state(problems, hp: MALAHyper, n_temps: int, n_chains: int,
                        generator: torch.Generator, init_scales=None):
    """Per-star init_state, star after star from one generator, stacked on a
    leading star axis.  Each star is initialised on its problem around the
    shared model closure, so the cached logL and gradients are those every
    later step computes.  `init_scales`: None, or one (Df,) array per
    star."""
    _, stars = _per_star_problems(problems)
    scales = init_scales or [None] * len(stars)
    return stack_states([
        init_state(p, hp, n_temps, n_chains, generator, init_scales=s)
        for p, s in zip(stars, scales)])


def run_ensemble_phase(problems, hp, betas, states, generator, n_steps,
                       adapt=True, thin=1, chunk=200, on_chunk=None,
                       on_state=None, already_emitted: int = 0,
                       stacked=None):
    """One phase over the star ensemble, chunked like driver.run_phase
    (bounded host buffering, streaming writers, mid-phase checkpoints): the
    records have (chunk, S, ...) shapes, and on_state(states,
    generator_state, emitted) gets the carry at each chunk boundary.
    `stacked`: stacked_problem(problems), built here if None."""
    if stacked is None:
        stacked = stacked_problem(problems)
    return run_phase(stacked, hp, betas, states, generator, n_steps,
                     adapt=adapt, thin=thin, chunk=chunk, on_chunk=on_chunk,
                     on_state=on_state, already_emitted=already_emitted)


def run_ensemble_phases(problems, hp, betas, states, generator,
                        plan: PhasePlan, on_phase_end=None, on_chunk=None,
                        on_state=None):
    """B -> L -> A over the whole star ensemble.  Returns (states, {phase:
    stacked host records with (E, S, ...) shapes})."""
    stacked = stacked_problem(problems)
    results = {}
    for name, n_steps, adapt in plan.phases():
        if n_steps <= 0:
            continue
        states, outs = run_ensemble_phase(
            problems, hp, betas, states, generator, n_steps, adapt=adapt,
            thin=plan.thin, chunk=plan.chunk,
            on_chunk=(None if on_chunk is None
                      else (lambda o, _n=name: on_chunk(_n, o))),
            on_state=(None if on_state is None
                      else (lambda s, g, e, _n=name: on_state(_n, s, g, e))),
            stacked=stacked)
        results[name] = outs
        if on_phase_end is not None:
            on_phase_end(name, states, outs)
    return states, results
