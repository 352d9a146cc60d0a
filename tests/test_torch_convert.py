"""tamcmc_tpu_torch.convert carries a reference problem of every family
across (it builds through the port's registry, the one table of names), and
the log-posterior pieces and their gradients agree.

One problem per family ported last: the aj, ajAlm and a1nl rotation laws of
MS_Global (ajAlm with static window segments), both MS_local models and the
ajfit table fit (the reference's demo).  The reference problem is made here
from seeded numpy parameters, its spectrum the reference model's own; both
packages evaluate `batched_logparts_and_grad` on the same (T, C, Df) walkers.
Tolerances as tests/test_torch_sampler.py: logL, logP rtol 1e-5; gradients
max abs diff / max abs <= 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.models import build_model as j_build_model
from tamcmc_tpu.models import registry as j_registry
from tamcmc_tpu.models.ms_global import MSGlobalSpec as JMSGlobalSpec
from tamcmc_tpu.sampler.problem import Problem as JProblem
from tamcmc_tpu.stats.assemblers import \
    build_family_constraints as j_constraints
from tamcmc_tpu.stats.priors import PriorTable as JPriorTable
from tamcmc_tpu_torch import convert
from tamcmc_tpu_torch.models import registry

torch.set_num_threads(1)

T, C = 2, 3
N_PER_L = (3, 3, 3, 1)
NU = np.linspace(2050.0, 2450.0, 900).astype(np.float32)
ROT = {"aj": [1.2, 0.05, 0.01, 0.004, 0.002, 0.001, 1.0, 0.02],
       "ajAlm": [1.2, 0.01, 0.002, 1.0, 1e-3, 0.5, 0.3, 0.02],
       "a1nl": [1.0, 1.2, 1.4, 1.3, 1.1, 0.9, 1.0, 0.01, 0.02]}


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def _ms_global_params(layout, rot):
    p = np.zeros(layout.ndim)
    f0 = 2115.0 + 100.0 * np.arange(3)
    off = {0: 0.0, 1: 48.0, 2: -9.0, 3: 25.0}
    for name in layout.names:
        o, s = layout.offset(name), layout.size(name)
        if name == "heights":
            p[o:o + s] = [4.0, 8.0, 5.0]
        elif name == "visibilities":
            p[o:o + s] = [1.5, 0.53, 0.07]
        elif name.startswith("freq_l"):
            p[o:o + s] = (f0 + off[int(name[-1])])[:s]
        elif name == "rot":
            p[o:o + s] = rot
        elif name == "widths":
            p[o:o + s] = [1.0, 1.5, 2.0]
        elif name == "noise":
            p[o:o + s] = [50.0, 2e-3, 4.0, 10.0, 4e-4, 2.0, -1, -1, 2.0, 0.2]
        elif name == "inclination":
            p[o] = 0.96
        elif name == "trunc":
            p[o] = 40.0
    return p


def _local_params(layout):
    rng = np.random.default_rng(1)
    p = np.zeros(layout.ndim)
    base = {0: 2115.0, 1: 2163.0, 2: 2106.0, 3: 2140.0}
    for name in layout.names:
        o, s = layout.offset(name), layout.size(name)
        if name.startswith("height_l"):
            p[o:o + s] = rng.uniform(2.0, 8.0, s)
        elif name.startswith("freq_l"):
            p[o:o + s] = base[int(name[-1])] + 100.0 * np.arange(s)
        elif name.startswith("width_l"):
            p[o:o + s] = rng.uniform(0.8, 2.5, s)
        elif name.startswith("hfactor_l"):
            p[o:o + s] = rng.uniform(0.2, 1.0, s)
        elif name == "rot":
            p[o:o + s] = [1.2, 0.03]
        elif name == "noise":
            p[o] = 0.6
        elif name == "inclination":
            p[o] = 0.9
    return p


def _reference_problem(case):
    """A reference Problem of the case's family: every parameter under a
    uniform prior around its value except the switches and the truncation,
    which are fixed; the spectrum is the model at params0 times 1.1."""
    if case == "ajfit":
        return j_make_demo("ajfit", seed=0)[0]
    if case.startswith("MS_local"):
        name = f"model_{case}"
        spec = j_registry._resolve_family(name).spec_cls(n_per_l=N_PER_L)
        fn, layout = j_build_model(name, spec)
        p0 = _local_params(layout)
        fixed = set()
    else:
        name = {"aj": "model_MS_Global_aj_HarveyLike",
                "ajAlm": "model_MS_Global_ajAlm_HarveyLike",
                "a1nl": "model_MS_Global_a1nl_etaa3_HarveyLike"}[case]
        spec = JMSGlobalSpec(n_per_l=N_PER_L)
        fn, layout = j_build_model(name, spec)
        p0 = _ms_global_params(layout, ROT[case])
        if case == "ajAlm":         # static window segments anchored at p0
            spec = dataclasses.replace(spec, window_hint=(
                tuple(float(v) for v in p0.astype(np.float32)),
                float(NU[0]), float(np.median(np.diff(NU.astype(np.float64)))),
                int(NU.shape[0]), 10.0))
            fn, layout = j_build_model(name, spec)
        names = layout.param_names()
        sw = {"aj": 6, "ajAlm": 3, "a1nl": 6}[case]
        fixed = {names.index("trunc"), layout.offset("rot") + sw} | {
            layout.offset("noise") + i for i in (6, 7)}
    rows = [(n, "fix") if i in fixed
            else (n, "uniform", float(v - 0.5 * abs(v) - 0.1),
                  float(v + 0.5 * abs(v) + 0.1))
            for i, (n, v) in enumerate(zip(layout.param_names(), p0))]
    # the reference's MS_local constraints raise (a block it names does not
    # exist), so that family's reference problem carries none
    extra = None if case.startswith("MS_local") else j_constraints(name,
                                                                   layout)
    p0 = jnp.asarray(p0, jnp.float32)
    nu = jnp.asarray(NU)
    return JProblem(model_fn=fn, layout=layout,
                    priors=JPriorTable.from_rows(rows), nu=nu,
                    spec=1.1 * fn(p0, nu), params0=p0, extra_logp=extra,
                    model_meta={"name": name, "spec": spec})


CASES = ["aj", "ajAlm", "a1nl", "MS_local_basic", "MS_local_Hnlm", "ajfit"]


@pytest.mark.parametrize("case", CASES)
def test_problem_from_reference_carries_the_family(case):
    jp = _reference_problem(case)
    tp = convert.problem_from_reference(jp)
    assert tp.model_meta["name"] == jp.model_meta["name"]
    assert (tp.layout.names, tp.layout.sizes) == \
        (jp.layout.names, jp.layout.sizes)
    assert tp.free_names == jp.free_names and tp.likelihood == jp.likelihood
    assert (getattr(tp.model_fn, "_window_groups", None)
            == getattr(jp.model_fn, "_window_groups", None))
    assert (tp._pieces_hook is not None) == (case == "ajAlm")
    if case.startswith("MS_local"):
        # the port's problem has the family's constraints all the same
        assert jp.extra_logp is None and tp.extra_logp is not None
    Df = jp.ndim_free
    rng = np.random.default_rng(3)
    x0 = np.asarray(jp.extract(jp.params0))
    # walkers 2e-4 of each value away: ~0.4 uHz on a frequency
    x = (x0 + (2e-4 * np.abs(x0) + 1e-5)
         * rng.standard_normal((T, C, Df))).astype(np.float32)
    (jl, jP), (jgl, jgp) = jax.jit(jp.batched_logparts_and_grad)(
        jnp.asarray(x))
    (tl, tP), (tgl, tgp) = tp.batched_logparts_and_grad(torch.as_tensor(x))
    assert np.all(np.isfinite(np.asarray(jl)))
    assert np.all(np.asarray(jP) > -1e29)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-5)
    assert _rel(tgl, jgl) <= 1e-3
    assert _rel(tgp, jgp) <= 1e-3
    assert np.abs(np.asarray(jgl)).max() > 0
    if case != "ajfit":
        # uniform and fixed rows only: a prior constant on its support has
        # a zero gradient in both packages (no graph reaches the walkers)
        assert not np.any(tgp.numpy()) and not np.any(np.asarray(jgp))


def test_convert_has_no_table_of_families_of_its_own():
    assert not hasattr(convert, "FAMILIES")
    spec, fn, layout = convert.build_model(
        "model_MS_Global_ajAlm_Harvey1985_Classic",
        {"n_per_l": [2, 2, 0, 0], "alm_filter": "gauss"})
    assert fn._family_name == "model_MS_Global_ajAlm_Harvey1985_Classic"
    assert spec.n_per_l == (2, 2, 0, 0) and layout.size("rot") == 8
    assert (fn._spec.rotation, fn._spec.noise_kind, fn._spec.alm_filter) == \
        ("ajAlm", "harvey_1985", "gauss")
    with pytest.raises(KeyError, match="unknown model"):
        convert.build_model("model_Nope")
    assert sorted(registry._FAMILIES) == sorted(
        n.lower() for n in registry.list_models()
        if registry.parse_model_name(n) is None
        or n.lower() in registry._FAMILIES)
