"""The PyTorch port's ajfit family (models/ajfit.py: a-coefficients plus the
Alm activity term fitted to a table of nu_nlm) against the JAX reference:
the model, its constraints and its demo.

The same float32 parameters, made from a seed with numpy, go through the
port as one batch and through the reference under vmap.  Tolerances
(float32): predicted frequencies rtol 1e-6 (one ulp of 2,200 uHz is 1.1e-7
relative); gradients within 1e-4 of each gradient's largest entry.  The
activity band stays off the clamp ties (delta far above 1e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.models import build_model as j_build_model
from tamcmc_tpu.models.ajfit import AjFitSpec as JAjFitSpec
from tamcmc_tpu.stats.assemblers import \
    build_family_constraints as j_constraints
from tamcmc_tpu_torch.demos import make_demo as t_make_demo
from tamcmc_tpu_torch.models import build_model
from tamcmc_tpu_torch.models.ajfit import AjFitSpec
from tamcmc_tpu_torch.stats.assemblers import build_family_constraints
from tamcmc_tpu_torch.stats.priors import NEG_BIG

torch.set_num_threads(1)

SPECS = {
    "demo": dict(l_per_multiplet=(1, 1, 1, 2, 2, 2)),
    "mixed-order": dict(l_per_multiplet=(2, 1, 3, 1), filter_kind="gauss"),
    "triangle": dict(l_per_multiplet=(3, 3), filter_kind="triangle"),
    "no-activity": dict(l_per_multiplet=(1, 2, 3), include_activity=False),
}


def _params(spec, seed, walkers=4):
    rng = np.random.default_rng(seed)
    n = len(spec.l_per_multiplet)
    p = np.zeros((walkers, spec.layout().ndim))
    p[:, :n] = 2200.0 + 100.0 * np.arange(n) + rng.normal(0, 0.3, (walkers, n))
    p[:, n:n + 6] = rng.normal(0, 1, (walkers, 6)) \
        * [0.1, 0.03, 0.015, 0.004, 0.002, 0.001] + [0.4, 0, 0, 0, 0, 0]
    if spec.include_activity:
        p[:, n + 6:] = np.stack([rng.uniform(2e-4, 3e-3, walkers),
                                 rng.uniform(0.2, 1.2, walkers),
                                 rng.uniform(0.1, 0.6, walkers)], -1)
    return p.astype(np.float32)


@pytest.mark.parametrize("case", list(SPECS))
def test_ajfit_model_matches_reference(case):
    jspec, tspec = JAjFitSpec(**SPECS[case]), AjFitSpec(**SPECS[case])
    jfn, jlay = j_build_model("model_ajfit", jspec)
    tfn, tlay = build_model("model_ajfit", tspec)
    assert (tlay.names, tlay.sizes) == (jlay.names, jlay.sizes)
    assert tspec.n_points == jspec.n_points
    assert tspec.point_labels() == jspec.point_labels()
    params = _params(tspec, len(case))
    g = np.random.default_rng(1).normal(
        size=(params.shape[0], tspec.n_points)).astype(np.float32)
    jf = jax.vmap(lambda r: jfn(r, None))
    want = np.asarray(jf(jnp.asarray(params)))
    want_g = np.asarray(jax.grad(lambda p: jnp.sum(g * jf(p)))(
        jnp.asarray(params)))
    leaf = torch.tensor(params, requires_grad=True)
    out = tfn(leaf, None, fixed=None)
    got_g, = torch.autograd.grad(out, leaf, torch.as_tensor(g))
    assert out.shape == (params.shape[0], tspec.n_points)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6)
    for b in tlay.names:
        sl = slice(tlay.offset(b), tlay.offset(b) + tlay.size(b))
        scale = np.abs(want_g[:, sl]).max()
        assert scale > 0, b
        assert np.abs(got_g.numpy()[:, sl] - want_g[:, sl]).max() \
            <= 1e-4 * scale, b
    # an unbatched vector gives its batch row
    np.testing.assert_allclose(tfn(torch.as_tensor(params[1]), None).numpy(),
                               out.detach().numpy()[1], rtol=1e-7)


def test_ajfit_spec_refuses_l0_multiplets():
    with pytest.raises(AssertionError, match="1 <= l <= 3"):
        AjFitSpec(l_per_multiplet=(0, 1))


def _base(layout):
    p = np.zeros(layout.ndim, np.float32)
    p[:2] = [100.0, 200.0]
    p[layout.offset("activity") + 2] = 0.1
    return p


def test_ajfit_constraints_match_reference():
    """Crossed centroids and each unphysical activity entry, the cases of
    the reference's own tests, and two violations at once (floored)."""
    spec = dict(l_per_multiplet=(1, 1))
    _, jlay = j_build_model("model_ajfit", JAjFitSpec(**spec))
    _, tlay = build_model("model_ajfit", AjFitSpec(**spec))
    jextra = j_constraints("model_ajfit", jlay)
    textra = build_family_constraints("model_ajfit", tlay)
    o = tlay.offset("activity")
    rows = [_base(tlay) for _ in range(7)]
    rows[1][0] = 300.0                  # crossed centroids
    rows[2][o] = -1e-3                  # epsilon < 0
    rows[3][o + 1] = 2.0                # theta0 > pi/2
    rows[4][o + 2] = 0.0                # delta below its floor
    rows[5][o + 1] = -0.1               # theta0 < 0
    rows[6][0], rows[6][o] = 300.0, -1.0
    rows = np.stack(rows)
    want = np.asarray(jax.vmap(jextra)(jnp.asarray(rows)))
    got = textra(torch.as_tensor(rows)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0 and np.all(got[1:] <= NEG_BIG / 2)
    # without the activity block only the ordering remains
    _, lay = build_model("model_ajfit", AjFitSpec(l_per_multiplet=(1, 1),
                                                  include_activity=False))
    extra = build_family_constraints("model_ajfit", lay)
    p = torch.as_tensor(np.asarray([100.0, 200.0, 0, 0, 0, 0, 0, 0],
                                   np.float32))
    assert float(extra(p)) == 0.0 and float(extra(p.flip(0))) <= NEG_BIG / 2


@pytest.mark.parametrize("seed", [0, 3])
def test_ajfit_demo_matches_reference(seed):
    """truth and params0 bitwise equal, the same table, priors, sampler and
    plan; the port's data are its own noise draw around the same model."""
    jp, jhp, jplan, jmeta = j_make_demo("ajfit", seed=seed)
    tp, thp, tplan, tmeta = t_make_demo("ajfit", seed=seed)
    np.testing.assert_array_equal(tp.params0.numpy(), np.asarray(jp.params0))
    np.testing.assert_array_equal(tmeta["truth"], jmeta["truth"])
    np.testing.assert_array_equal(tp.nu.numpy(), np.asarray(jp.nu))
    np.testing.assert_array_equal(tp.sigma_spec.numpy(),
                                  np.asarray(jp.sigma_spec))
    assert tp.likelihood == jp.likelihood == "chi_square"
    assert {k: v for k, v in tmeta.items() if k != "truth"} == \
        {k: v for k, v in jmeta.items() if k != "truth"}
    assert dataclasses.asdict(thp) == dataclasses.asdict(jhp)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert tp.free_names == jp.free_names
    assert dataclasses.asdict(tp.model_meta["spec"]) == \
        dataclasses.asdict(jp.model_meta["spec"])
    np.testing.assert_array_equal(tp.priors.kinds, jp.priors.kinds)
    np.testing.assert_array_equal(tp.priors.hypers, jp.priors.hypers)
    # both draw N(model, 0.03): the two tables differ by noise only
    resid = (tp.spec.numpy() - np.asarray(jp.spec)) / 0.03
    assert 0.3 < resid.std() < 3.0 and np.abs(resid).max() < 8.0
    # the problem evaluates: the constraint is satisfied at the start
    logL, logP = tp.log_parts(tp.extract(tp.params0))
    assert np.isfinite(float(logL)) and float(logP) > NEG_BIG / 2
