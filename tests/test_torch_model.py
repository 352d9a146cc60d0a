"""The PyTorch port's model pieces against the JAX reference: noise,
rotation, visibilities, interpolation, the MS_Global model and its demo.

Inputs are made once with numpy from a seed and fed to both packages; the
JAX demo's spectrum (drawn from a JAX key) is passed to the port, never
redrawn.  Tolerances (float32): values rtol 2e-5, atol 1e-5 (1e-4 relative
for the full model spectrum, whose pow/exp terms round differently per
framework); gradients rtol 3e-3, atol 3e-4 relative to the gradient scale.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu.models.common import interp_monotonic as j_interp
from tamcmc_tpu.ops.noise import noise_background as j_noise
from tamcmc_tpu.ops.rotation import split_frequencies_a1etaa3 as j_split
from tamcmc_tpu.ops.visibilities import mode_visibility as j_vis
from tamcmc_tpu_torch import convert
from tamcmc_tpu_torch.demos import make_demo as t_make_demo
from tamcmc_tpu_torch.models.common import interp_monotonic as t_interp
from tamcmc_tpu_torch.ops.noise import noise_background as t_noise
from tamcmc_tpu_torch.ops.rotation import split_frequencies_a1etaa3 as t_split
from tamcmc_tpu_torch.ops.visibilities import mode_visibility as t_vis

torch.set_num_threads(1)

VAL = dict(rtol=2e-5, atol=1e-5)
GRAD = dict(rtol=3e-3, atol=3e-4)


def _grads_t(fn, args, g):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*leaves)
    return out.detach().numpy(), [x.numpy() for x in torch.autograd.grad(
        out, leaves, torch.as_tensor(g))]


def _grads_j(fn, args, g):
    ja = [jnp.asarray(a) for a in args]
    out = np.asarray(fn(*ja))
    gr = jax.grad(lambda *a: jnp.sum(g * fn(*a)),
                  argnums=tuple(range(len(args))))(*ja)
    return out, [np.asarray(x) for x in gr]


def _assert_close(got, want, val=VAL):
    np.testing.assert_allclose(got[0], want[0], **val)
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        scale = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a / scale, b / scale, err_msg=f"arg {i}",
                                   **GRAD)


@pytest.mark.parametrize("kind", ["harvey_like", "harvey_1985"])
def test_noise_background(kind):
    rng = np.random.default_rng(0)
    nu = np.linspace(50.0, 4000.0, 301).astype(np.float32)
    noise = np.tile(np.asarray([50.0, 2e-3, 4.0, 10.0, 4e-4, 2.0,
                                -1.0, -1.0, 2.0, 0.2], np.float32), (3, 1))
    noise[:, [0, 3, 9]] *= rng.uniform(0.5, 2.0, (3, 3)).astype(np.float32)
    if kind == "harvey_1985":
        noise[:, [1, 4]] = rng.uniform(0.1, 1.0, (3, 2)).astype(np.float32)
    g = rng.normal(size=(3, 301)).astype(np.float32)
    want = _grads_j(lambda n: jax.vmap(
        lambda r: j_noise(jnp.asarray(nu), r, kind=kind))(n), [noise], g)
    got = _grads_t(lambda n: t_noise(torch.as_tensor(nu), n, kind=kind),
                   [noise], g)
    _assert_close(got, want)


@pytest.mark.parametrize("free", [
    (9,),                  # the demo: Harvey A/B/p fixed, white level free
    (),                    # everything fixed: one unbatched row
    (3, 4, 9),             # one Harvey component partly free
])
def test_noise_background_const_split(free):
    """The all-fixed terms read from noise0 give the batched values (equal
    up to float32 rounding), no gradient into the blocks read from noise0,
    and an unbatched result when nothing is free."""
    rng = np.random.default_rng(1)
    nu = torch.as_tensor(np.linspace(50.0, 4000.0, 301).astype(np.float32))
    noise0 = np.asarray([50.0, 2e-3, 4.0, 10.0, 4e-4, 2.0, -1.0, -1.0, 2.0,
                         0.2], np.float32)
    rows = np.tile(noise0, (3, 1))
    rows[:, list(free)] *= rng.uniform(0.5, 2.0, (3, len(free)))
    fixed = np.ones(10, bool)
    fixed[list(free)] = False
    g = torch.as_tensor(rng.normal(size=(3, 301)).astype(np.float32))
    runs = []
    for const in (None, (torch.as_tensor(noise0), fixed)):
        leaf = torch.tensor(rows, requires_grad=True)
        out = t_noise(nu, leaf, const=const)
        grad = (torch.autograd.grad((g * out).sum(), leaf)[0].numpy()
                if out.requires_grad else np.zeros_like(rows))
        runs.append((out.detach(), grad))
    (want, want_g), (got, got_g) = runs
    if not free:
        assert got.shape == (301,)
    np.testing.assert_allclose(got.expand_as(want).numpy(), want.numpy(),
                               rtol=1e-6)
    # a block (one Harvey component, or the white level) is read from noise0
    # only when all of it is fixed; a partly free block stays batched
    blocks = [slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 10)]
    once = np.zeros(10, bool)
    for b in blocks:
        once[b] = fixed[b].all()
    np.testing.assert_allclose(got_g[:, ~once], want_g[:, ~once], rtol=1e-6)
    assert not np.any(got_g[:, once])


@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_split_frequencies_a1etaa3(l):
    rng = np.random.default_rng(l)
    nu_nl = rng.uniform(2000, 3000, (4, 5)).astype(np.float32)
    a1 = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    eta0 = rng.uniform(1e8, 3e8, 4).astype(np.float32)
    a3 = rng.uniform(-0.1, 0.1, 4).astype(np.float32)
    g = rng.normal(size=(4, 5, 2 * l + 1)).astype(np.float32)
    want = _grads_j(lambda *a: jax.vmap(
        lambda n, a1_, e, a3_: j_split(l, n, a1_, e, a3_))(*a),
        [nu_nl, a1, eta0, a3], g)
    got = _grads_t(lambda n, a1_, e, a3_: t_split(l, n, a1_[:, None], e, a3_),
                   [nu_nl, a1, eta0, a3], g)
    _assert_close(got, want)


@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_mode_visibility(l):
    rng = np.random.default_rng(10 + l)
    inc = rng.uniform(0.0, np.pi / 2, 6).astype(np.float32)
    g = rng.normal(size=(6, 2 * l + 1)).astype(np.float32)
    if l == 0:                    # constant: no gradient to compare
        got = t_vis(0, torch.as_tensor(inc)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jax.vmap(lambda x: j_vis(0, x))(jnp.asarray(inc))))
        return
    want = _grads_j(lambda i: jax.vmap(lambda x: j_vis(l, x))(i), [inc], g)
    got = _grads_t(lambda i: t_vis(l, i), [inc], g)
    _assert_close(got, want)
    np.testing.assert_allclose(got[0].sum(-1), 1.0, rtol=1e-6)


def test_interp_monotonic_values_and_grads():
    """Inside, outside (clamped) and exactly at the knots, with gradients
    into x, the knots xp and the values fp, batched over walkers."""
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(2000, 3000, (4, 6)), axis=-1).astype(np.float32)
    fp = rng.uniform(0.5, 5.0, (4, 6)).astype(np.float32)
    x = np.concatenate([rng.uniform(1900, 3100, (4, 7)), xp[:, 1:3],
                        xp[:, :1] - 5.0, xp[:, -1:] + 5.0],
                       axis=-1).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    want = _grads_j(lambda *a: jax.vmap(j_interp)(*a), [x, xp, fp], g)
    got = _grads_t(t_interp, [x, xp, fp], g)
    _assert_close(got, want)
    np.testing.assert_array_equal(got[0][:, -2], fp[:, 0])
    np.testing.assert_array_equal(got[0][:, -1], fp[:, -1])


@pytest.fixture(scope="module")
def small_demo():
    """Reference demo at ngrid=4000, 3 orders and the port's problem built
    from its arrays (the reference's spectrum passed in)."""
    jp, _, _, _ = j_make_demo("ms_global", seed=0, ngrid=4000, n_orders=3)
    tp = convert.problem_from_reference(jp)
    rng = np.random.default_rng(5)
    full = np.asarray(jp.params0)[None, :].repeat(3, 0)
    free = jp.priors.free_mask
    full[:, free] += 0.05 * rng.standard_normal((3, free.sum())) \
        * np.maximum(np.abs(full[:, free]) * 1e-3, 1e-3)
    return jp, tp, full.astype(np.float32)


def test_model_fn_matches_jax(small_demo):
    jp, tp, full = small_demo
    assert tp.model_fn._window_groups == jp.model_fn._window_groups
    rng = np.random.default_rng(6)
    g = rng.normal(size=(3, jp.nu.shape[0])).astype(np.float32)
    want = _grads_j(jax.jit(jax.vmap(lambda r: jp.model_fn(r, jp.nu))),
                    [full], g)
    got = _grads_t(lambda p: tp.model_fn(p, tp.nu), [full], g)
    _assert_close(got, want, val=dict(rtol=1e-4, atol=1e-5))


def test_segments_and_bg_match_jax(small_demo):
    jp, tp, full = small_demo
    pieces, bg = tp.model_fn._segments_and_bg(torch.as_tensor(full), tp.nu)
    bounds = [(lo, hi) for lo, hi, _ in pieces]

    @jax.jit
    @jax.vmap
    def j_pieces(r):
        segs, jbg = jp.model_fn._segments_and_bg(r, jp.nu)
        assert [(lo, hi) for lo, hi, _ in segs] == bounds
        return [v for _, _, v in segs], [jbg(lo, hi) for lo, hi in bounds]

    jvals, jbgs = j_pieces(jnp.asarray(full))
    for (lo, hi, tv), jv, jb in zip(pieces, jvals, jbgs):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **VAL)
        np.testing.assert_allclose(bg(lo, hi).numpy(), np.asarray(jb),
                                   rtol=1e-5)


def test_segments_and_bg_fixed_noise_matches_jax(small_demo):
    """Given the Problem's (params0, fixed mask), the hook's background
    still matches the reference, and only the free white level carries a
    gradient: the fixed Harvey terms are evaluated once, outside autograd."""
    jp, tp, full = small_demo
    fixed = ~tp.priors.free_mask
    leaf = torch.tensor(full, requires_grad=True)
    _, bg = tp.model_fn._segments_and_bg(leaf, tp.nu,
                                         fixed=(tp.params0, fixed))
    n = tp.nu.shape[0]
    jbg = jax.vmap(lambda r: jp.model_fn._segments_and_bg(r, jp.nu)[1](0, n))(
        jnp.asarray(full))
    got = bg(0, n)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jbg),
                               rtol=1e-5)
    grad = torch.autograd.grad(got.sum(), leaf)[0].numpy()
    noise = slice(tp.layout.offset("noise"),
                  tp.layout.offset("noise") + tp.layout.size("noise"))
    assert np.all(grad[:, noise][:, fixed[noise]] == 0)
    assert np.all(grad[:, noise][:, ~fixed[noise]] != 0)


# the first two keep their ids; the full-size cases of configs 3 and 4 also
# pin the segment counts and component-bins per walker
@pytest.mark.parametrize("name,kw", [
    pytest.param("ms_global", dict(ngrid=4000, n_orders=3), id="kw0"),
    pytest.param("ms_global", dict(), id="kw1"),
    pytest.param("kepler_full", dict(ngrid=4000, n_orders=3),
                 id="kepler_full-small"),
    pytest.param("kepler_full", dict(), id="kepler_full"),
    pytest.param("subgiant_mixed", dict(ngrid=3000, n_orders=3),
                 id="subgiant_mixed-small"),
    pytest.param("subgiant_mixed", dict(), id="subgiant_mixed"),
    pytest.param("subgiant_mixed_inertia", dict(ngrid=3000, n_orders=2),
                 id="subgiant_mixed_inertia-small"),
    pytest.param("subgiant_mixed_inertia", dict(),
                 id="subgiant_mixed_inertia"),
    pytest.param("single_lorentzian", dict(seed=3), id="single_lorentzian"),
    pytest.param("harvey_background", dict(seed=3),
                 id="harvey_background-seed3"),
    pytest.param("harvey_background", dict(), id="harvey_background"),
])
def test_make_demo_matches_jax_bitwise(name, kw):
    """truth and params0 bitwise equal, hence identical window segments
    (config 3: 35 segments, 536,675 component-bins per walker at full size;
    config 4: 194 segments, 3,682,749)."""
    kw = dict(seed=0, **kw) if "seed" not in kw else kw
    jp, jhp, jplan, jmeta = j_make_demo(name, **kw)
    tp, thp, tplan, tmeta = t_make_demo(name, **kw)
    np.testing.assert_array_equal(tp.params0.numpy(), np.asarray(jp.params0))
    np.testing.assert_array_equal(tmeta["truth"], jmeta["truth"])
    assert tmeta["truth"].dtype == np.asarray(jmeta["truth"]).dtype
    assert tp.nu.shape == jp.nu.shape
    assert tp.likelihood == jp.likelihood
    assert (tp.sigma_spec is None) == (jp.sigma_spec is None)
    assert tp.model_meta["name"] == jp.model_meta["name"]
    assert {k: v for k, v in tmeta.items() if k != "truth"} == \
        {k: v for k, v in jmeta.items() if k != "truth"}
    assert (getattr(tp.model_fn, "_window_groups", None)
            == getattr(jp.model_fn, "_window_groups", None))
    assert dataclasses.asdict(thp) == dataclasses.asdict(jhp)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert tp.free_names == jp.free_names
    if jp.model_meta["spec"] is not None:
        assert dataclasses.asdict(tp.model_meta["spec"]) == \
            dataclasses.asdict(jp.model_meta["spec"])
    if not kw.keys() - {"seed"} and name in ("ms_global", "kepler_full"):
        segs, bins = {"ms_global": (35, 536_675),
                      "kepler_full": (194, 3_682_749)}[name]
        assert len(tp.model_fn._window_groups) == segs
        assert tp.model_fn._plan.comp_bins() == bins
