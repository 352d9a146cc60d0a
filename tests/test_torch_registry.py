"""The PyTorch port's model registry against the JAX reference's: the list
of names, the name grammar, the alias note, and one case per buildable
name.

Every name builds in both packages at n_per_l = (3, 3, 3, 1) (RGB: 3
orders) on a 600-bin grid.  The same float32 parameters, made from a seed
with numpy, go through the port as one batch of 3 walkers and through the
reference as 3 single calls.  Tolerances (float32): spectrum rtol 2e-5,
atol 1e-6; the gradient of a weighted sum of the spectrum within 1e-3 of
its largest entry.  Widths are ~1 uHz: an ulp of a 120 uHz centre
(7.6e-6 uHz), which the two packages' assembly may differ by, moves a
profile of width Gamma by up to ~ulp / Gamma relative.  Parameters stay off
the ties of every clamp (delta well above 1e-3, widths above their floor,
no activity filter exactly 0 or 1), where the two packages would split a
gradient differently.

The 18 RGB names of the product are held the same way in
tests/test_torch_registry_rgb.py, which takes its helpers from this file.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.models import registry as j_registry
from tamcmc_tpu.models.ms_global import MSGlobalSpec as JMSSpec
from tamcmc_tpu_torch.models import build_model, list_models, registry
from tamcmc_tpu_torch.models.asymptotic import RGBAsymptSpec
from tamcmc_tpu_torch.models.ms_global import MSGlobalSpec

torch.set_num_threads(1)

NAMES = j_registry.list_models()
MS_NAMES = [n for n in NAMES if n.startswith("model_MS_Global_")]
RGB_NAMES = [n for n in NAMES if n.startswith("model_RGB_asympt_")]
OTHER_NAMES = [n for n in NAMES if n not in MS_NAMES + RGB_NAMES]

N_BINS = 600
N_PER_L = (3, 3, 3, 1)
NU_LO, NU_HI = 100.0, 140.0
SPECTRUM = dict(rtol=2e-5, atol=1e-6)
GRAD_REL = 1e-3


def generic_params0(lay, rng, walkers=3):
    """(walkers, D) plausible float32 parameters for any MS_Global or RGB
    layout, filled by block name; every walker a small perturbation."""
    n0 = 3
    dnu = (NU_HI - NU_LO) / (n0 + 1)
    f0 = NU_LO + dnu * (np.arange(n0) + 0.6)
    p = np.zeros(lay.ndim)
    sd = np.zeros(lay.ndim)
    for name in lay.names:
        o, s = lay.offset(name), lay.size(name)
        if name == "heights":
            p[o:o + s], sd[o:o + s] = 5.0, 0.2
        elif name == "visibilities":
            p[o:o + s] = [1.5, 0.53, 0.08][:s]
        elif name.startswith("freq_l"):
            l = int(name[-1])
            p[o:o + s] = (f0 - 0.12 * dnu * l)[:s]
            sd[o:o + s] = 0.02
        elif name == "rot":
            p[o:o + s], sd[o:o + s] = _rot_values(s, n0)
        elif name == "mixed":
            p[o:o + s] = [80.0, 0.0, 0.15, 0.0, 0.0, 0.0][:s]
            sd[o:o + 3] = [0.2, 0.01, 0.005]
        elif name == "widths":
            if s == 6:                      # the Appourchaux+2016 relation
                p[o:o + s] = [0.5 * (NU_LO + NU_HI), 3.0, 1.5, 2.0,
                              0.5 * (NU_LO + NU_HI), NU_HI - NU_LO]
            else:
                p[o:o + s], sd[o:o + s] = 0.8, 0.01
        elif name == "noise":
            p[o:o + s] = ([2.0, 0.05, 2.0] * ((s - 1) // 3) + [0.1])[:s]
        elif name == "inclination":
            p[o], sd[o] = 1.0, 0.05
        elif name == "trunc":
            p[o] = 40.0
        elif name in ("mix_hfact", "mix_wfact"):
            p[o:o + s], sd[o:o + s] = 1.0, 0.1
        elif name == "mix_fshift":
            sd[o:o + s] = 0.02
        else:
            raise AssertionError(f"generic_params0: unknown block {name}")
    return (p + sd * rng.standard_normal((walkers, lay.ndim))) \
        .astype(np.float32)


def _rot_values(size, n0):
    """(values, walker scatter) of a rot block, recognised by its size at
    n0 = 3: 3 RGB [a1_env, a1_core, asym]; 4 a1etaa3 / a1a2a3; 5 a1l;
    n0+3 a1n; 8 aj / ajAlm (the same values serve both: a1, small
    coefficients, eta switch on at index 3 or 6, an activity band away from
    the clamp ties); 2 n0 + 3 a1nl."""
    v, sd = np.zeros(size), np.zeros(size)
    if size == 3:
        v[:2], sd[:2] = [0.05, 0.4], 0.005
    elif size == 4:
        v[:], sd[:3] = [0.4, 0.05, 0.01, 0.02], [0.02, 0.0, 0.002]
        v[1] = 1.0          # a1etaa3: the eta switch; a1a2a3: a2 = 1 uHz
    elif size == 5:
        v[:], sd[:2] = [0.4, 0.5, 1.0, 0.01, 0.02], 0.02
    elif size == n0 + 3:
        v[:n0], sd[:n0] = [0.35, 0.4, 0.45], 0.02
        v[n0:] = [1.0, 0.01, 0.02]
    elif size == 8:
        # aj: a1..a6, eta_sw, asym; ajAlm: a1, a3, a5, eta_sw, epsilon,
        # theta0, delta, asym.  Entry 3 (a4 / eta switch) and entry 6
        # (eta switch / delta = 0.9 rad) are read by both without harm.
        v[:] = [0.4, 0.03, 0.01, 1.0, 2e-3, 0.5, 0.9, 0.02]
        sd[:3] = [0.02, 0.002, 0.001]
        sd[4:7] = [1e-4, 0.03, 0.03]
    elif size == 2 * n0 + 3:
        v[:2 * n0] = [0.35, 0.4, 0.45, 0.5, 0.45, 0.4]
        sd[:2 * n0] = 0.02
        v[2 * n0:] = [1.0, 0.01, 0.02]
    else:
        raise AssertionError(f"rot block of size {size}")
    return v, sd


def _j_values_and_grads(jfn, params, nu, g):
    """The reference through single calls: spectrum rows and the gradient
    of sum(g_i * spectrum_i) per walker."""
    jnu = jnp.asarray(nu)
    model = jax.jit(lambda p: jfn(p, jnu))
    grad = jax.jit(jax.grad(lambda p, gi: jnp.sum(gi * jfn(p, jnu))))
    want = np.stack([np.asarray(model(jnp.asarray(r))) for r in params])
    want_g = np.stack([np.asarray(grad(jnp.asarray(r), jnp.asarray(gi)))
                       for r, gi in zip(params, g)])
    return want, want_g


def _t_values_and_grads(tfn, params, nu, g):
    leaf = torch.tensor(params, requires_grad=True)
    out = tfn(leaf, torch.tensor(nu))
    got_g, = torch.autograd.grad(out, leaf, torch.as_tensor(g))
    return out.detach().numpy(), got_g.numpy()


def _hold(name, jfn, tfn, params, nu, seed):
    g = np.random.default_rng(seed).normal(
        size=(params.shape[0], nu.shape[0])).astype(np.float32)
    want, want_g = _j_values_and_grads(jfn, params, nu, g)
    got, got_g = _t_values_and_grads(tfn, params, nu, g)
    assert np.all(np.isfinite(want)) and np.all(want > 0), name
    np.testing.assert_allclose(got, want, err_msg=name, **SPECTRUM)
    scale = np.abs(want_g).max(axis=1, keepdims=True)
    assert np.all(scale > 0), name
    assert np.abs(got_g - want_g).max() / scale.max() <= GRAD_REL, name
    # every walker's own gradient, at its own scale
    assert np.all(np.abs(got_g - want_g).max(axis=1) / scale[:, 0]
                  <= GRAD_REL), name


def _nu():
    return np.linspace(NU_LO, NU_HI, N_BINS).astype(np.float32)


def test_list_models_equals_reference_letter_for_letter():
    assert list_models() == NAMES
    assert len(NAMES) == 55 and len(MS_NAMES) + len(RGB_NAMES) >= 46


@pytest.mark.parametrize("name", [
    "model_MS_Global_a1nl_etaa3_AppWidth_Harvey1985",
    "model_RGB_asympt_a1etaa3_freeWidth_HarveyLike_v3",
    "model_RGB_asympt_a1etaa3_AppWidth_Harvey1985_v2",
    "model_MS_Global_aj_Harvey1985_Classic",
    "model_MS_Global_ajAlm_HarveyLike_v4",
    "model_MS_Global_a1etaa3_Lorentz",          # not in the grammar
    "model_MS_Global_bogus_HarveyLike",
    "model_RGB_asympt_aj_HarveyLike",           # RGB is a1etaa3 only
    "model_Single_Lorentzian",                  # explicit entries only
    " Model_ms_global_A1L_etaa3_harveylike ",
])
def test_parse_model_name_matches_reference(name):
    assert registry.parse_model_name(name) == j_registry.parse_model_name(name)


def test_unknown_name_raises_keyerror():
    with pytest.raises(KeyError, match="unknown model"):
        build_model("model_MS_Global_bogus_HarveyLike",
                    MSGlobalSpec(n_per_l=N_PER_L))


def test_name_overrides_spec_fields():
    _, lay = build_model("model_MS_Global_aj_HarveyLike",
                         MSGlobalSpec(n_per_l=N_PER_L, rotation="a1etaa3"))
    assert lay.size("rot") == 8
    fn, _ = build_model("model_MS_Global_ajAlm_HarveyLike", n_per_l=N_PER_L)
    assert fn._family_name == "model_MS_Global_ajAlm_HarveyLike"
    assert fn._family_spec == MSGlobalSpec(n_per_l=N_PER_L)
    assert fn._spec.rotation == "ajAlm"


def test_alias_note_is_printed_once_per_name(capsys):
    spec = MSGlobalSpec(n_per_l=N_PER_L, n_harvey=1)
    registry._WARNED_VARIANTS.clear()
    build_model("model_MS_Global_aj_Harvey1985_v2", spec)
    err = capsys.readouterr().err
    assert "ALIAS" in err and "_v2" in err
    build_model("model_MS_Global_aj_Harvey1985_v2", spec)
    assert "ALIAS" not in capsys.readouterr().err
    # RGB v2/v3 are real per-mode switches, not aliases: no note
    registry._WARNED_VARIANTS.clear()
    build_model("model_RGB_asympt_a1etaa3_HarveyLike_v2",
                RGBAsymptSpec(n_orders=3, numin=NU_LO, numax_win=NU_HI,
                              n_p_poles=5, n_g_poles=12, n_harvey=1))
    assert "ALIAS" not in capsys.readouterr().err
    # the explicit _Classic entry notes its alias too
    build_model("model_MS_Global_a1etaa3_HarveyLike_Classic", spec)
    assert "ALIAS" in capsys.readouterr().err


@pytest.mark.parametrize("name", MS_NAMES)
def test_ms_global_name_matches_reference(name):
    kw = dict(n_per_l=N_PER_L, n_harvey=1)
    jfn, jlay = j_registry.build_model(name, JMSSpec(**kw))
    tfn, tlay = build_model(name, MSGlobalSpec(**kw))
    assert (tlay.names, tlay.sizes) == (jlay.names, jlay.sizes)
    params = generic_params0(tlay, np.random.default_rng(len(name)))
    _hold(name, jfn, tfn, params, _nu(), seed=1)


@pytest.mark.parametrize("name", OTHER_NAMES)
def test_explicit_name_builds_the_reference_layout(name):
    """The explicit entries outside the two combinator families (local,
    ajfit, test and background models) resolve to the reference's spec
    class fields and layout; their values are held in their own files."""
    jfam = j_registry._resolve_family(name)
    tfam = registry._resolve_family(name)
    assert tfam.name == jfam.name == name and tfam.doc == jfam.doc
    jfields = [(f.name, f.default) for f in dataclasses.fields(jfam.spec_cls)]
    tfields = [(f.name, f.default) for f in dataclasses.fields(tfam.spec_cls)]
    assert [n for n, _ in tfields] == [n for n, _ in jfields]
    kw = {} if all(d is not dataclasses.MISSING for _, d in jfields) \
        else dict(n_per_l=N_PER_L)
    _, jlay = j_registry.build_model(name, **kw)
    _, tlay = build_model(name, **kw)
    assert (tlay.names, tlay.sizes) == (jlay.names, jlay.sizes)
