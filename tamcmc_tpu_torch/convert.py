"""Carry problems and sampler states across between tamcmc_tpu and this
package as numpy arrays (neither package imports the other).

The parity tests feed both packages the same problem and state: the JAX
demo's spectrum comes from a JAX key, so it is passed in, never redrawn.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tamcmc_tpu_torch.demos import MODEL_NAME
from tamcmc_tpu_torch.models.ms_global import MSGlobalSpec, build_ms_global
from tamcmc_tpu_torch.sampler.problem import Problem
from tamcmc_tpu_torch.sampler.state import SamplerState
from tamcmc_tpu_torch.stats.assemblers import build_family_constraints
from tamcmc_tpu_torch.stats.priors import PriorTable


def problem_from_arrays(nu, spec, params0, kinds, hypers, names, spec_fields,
                        device="cpu") -> Problem:
    """The port's MS_Global problem from the reference problem's arrays.

    spec_fields: the reference MSGlobalSpec's fields as a dict
    (dataclasses.asdict), window_hint included."""
    fields = dict(spec_fields)
    fields["n_per_l"] = tuple(fields["n_per_l"])
    spec_obj = MSGlobalSpec(**fields)
    fn, layout = build_ms_global(spec_obj)

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return Problem(model_fn=fn, layout=layout,
                   priors=PriorTable(np.asarray(kinds, dtype=np.int32),
                                     np.asarray(hypers, dtype=np.float64),
                                     tuple(names)),
                   nu=f32(nu), spec=f32(spec), params0=f32(params0),
                   extra_logp=build_family_constraints(MODEL_NAME, layout),
                   model_meta={"name": MODEL_NAME, "spec": spec_obj})


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
