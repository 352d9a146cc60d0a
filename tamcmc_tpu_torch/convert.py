"""Carry problems and sampler states across between tamcmc_tpu and this
package as numpy arrays (neither package imports the other).

The parity tests feed both packages the same problem and state: the JAX
demo's spectrum comes from a JAX key, so it is passed in, never redrawn.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tamcmc_tpu_torch.models import registry
from tamcmc_tpu_torch.sampler.problem import Problem
from tamcmc_tpu_torch.sampler.state import SamplerState
from tamcmc_tpu_torch.stats.assemblers import build_family_constraints
from tamcmc_tpu_torch.stats.priors import PriorTable


def build_model(model_name: str, spec_fields=None):
    """(spec, model_fn, layout) of any registry name (models/registry.py)
    from the reference's model name and its spec's fields
    (dataclasses.asdict of the reference spec, window_hint included; None
    for the family's default spec)."""
    fields = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in (spec_fields or {}).items()}
    fn, layout = registry.build_model(model_name, **fields)
    return fn._family_spec, fn, layout


def problem_from_arrays(model_name, nu, spec, params0, kinds, hypers, names,
                        spec_fields=None, likelihood="chi22p",
                        sigma_spec=None, device="cpu") -> Problem:
    """The port's problem from the reference problem's arrays, its model
    name and its spec's fields (see build_model)."""
    spec_obj, fn, layout = build_model(model_name, spec_fields)

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return Problem(model_fn=fn, layout=layout,
                   priors=PriorTable(np.asarray(kinds, dtype=np.int32),
                                     np.asarray(hypers, dtype=np.float64),
                                     tuple(names)),
                   nu=f32(nu), spec=f32(spec), params0=f32(params0),
                   likelihood=likelihood,
                   sigma_spec=None if sigma_spec is None else f32(sigma_spec),
                   extra_logp=build_family_constraints(model_name, layout),
                   model_meta={"name": model_name, "spec": spec_obj})


def problem_from_reference(ref, device="cpu") -> Problem:
    """problem_from_arrays of a reference Problem, read through its
    attributes (arrays converted with np.asarray)."""
    spec = ref.model_meta["spec"]
    sigma = ref.sigma_spec
    return problem_from_arrays(
        ref.model_meta["name"], np.asarray(ref.nu), np.asarray(ref.spec),
        np.asarray(ref.params0), ref.priors.kinds, ref.priors.hypers,
        ref.priors.names,
        None if spec is None else dataclasses.asdict(spec),
        likelihood=ref.likelihood,
        sigma_spec=None if sigma is None else np.asarray(sigma),
        device=device)


def state_from_arrays(arrays: dict, device="cpu") -> SamplerState:
    """SamplerState from {field: np.ndarray} (a reference state's fields,
    each np.asarray'd); `step` becomes a host integer."""
    kw = {}
    for f in dataclasses.fields(SamplerState):
        a = arrays[f.name]
        kw[f.name] = (int(np.asarray(a)) if f.name == "step"
                      else torch.tensor(np.asarray(a), device=device))
    return SamplerState(**kw)


def state_to_arrays(state: SamplerState) -> dict:
    """{field: np.ndarray}; `step` as an int32 scalar, as the reference
    stores it."""
    return {f.name: (np.asarray(state.step, dtype=np.int32)
                     if f.name == "step"
                     else getattr(state, f.name).detach().cpu().numpy())
            for f in dataclasses.fields(SamplerState)}
