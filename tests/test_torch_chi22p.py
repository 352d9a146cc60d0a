"""The fused likelihood (ops/lorentzian.py lorentzian_chi22p) on the CPU.

On the card a chi22p fit without a mask takes one forward kernel whose
epilogue forms the likelihood on its register tile (csrc/lorentzian.cu
chi22p_epilogue); here the routed entry point runs its plain version, the
unfused chain.  The tests hold

  * the routed path against the JAX package: the port's
    `logparts_and_grad` against the reference's `batched_logparts_and_grad`
    on the reduced ms_global demo (segment plan) and a small subgiant_mixed
    demo (dense plan), carried across with convert.problem_from_reference:
    logL within 1e-5 relative, the gradient within 1e-5 of its largest
    entry (float32 sums over the grid in two orders);
  * the plain version against today's chain (the mode sum plus the
    background through stats/likelihoods.py) for every background form the
    models hand it (none per walker, a white level (..., 1), a free Harvey
    term (..., N)), a stack of two stars and the M = 0 floor: bitwise, since
    it is that chain;
  * the kernel route's host side (rows of a stacked spectrum, the
    per-walker background flattened to (Bt,) or (Bt, N)) with the kernel
    replaced by a torch emulation of its contract: within 1e-6 relative;
  * the epilogue's arithmetic (t and g per bin, the floor) against autograd
    of the chain (logL within 1e-6 relative, g bit for bit), and its
    reduction order
    (lorentzian_kernel.chi22p_tile_sums, per-(walker, tile) records added
    in tile order) over grids with gaps and a ragged last tile against
    torch.sum within 1e-5 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.demos import make_demo as j_make_demo
from tamcmc_tpu_torch import convert
from tamcmc_tpu_torch.demos import make_demo as t_make_demo
from tamcmc_tpu_torch.ops import lorentzian as L
from tamcmc_tpu_torch.ops import lorentzian_kernel as K
from tamcmc_tpu_torch.sampler.ensemble import stacked_problem
from tamcmc_tpu_torch.stats.likelihoods import likelihood_chi22p

torch.set_num_threads(2)

T, C = 2, 3


def _rel(a, b):
    """max |a - b| / max |b|."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def _walkers(x0, rng, shape, spread=2e-4):
    return (x0 + (spread * np.abs(x0) + 1e-5)
            * rng.standard_normal(shape + x0.shape)).astype(np.float32)


DEMOS = {"ms_global": dict(ngrid=2000, n_orders=2),
         "subgiant_mixed": dict(ngrid=3000)}


@pytest.mark.parametrize("demo", sorted(DEMOS))
def test_routed_logparts_match_jax(demo):
    jp, _, _, _ = j_make_demo(demo, seed=0, **DEMOS[demo])
    tp = convert.problem_from_reference(jp)
    assert tp._chi22p_hook is not None
    plan = tp._chi22p_hook(tp.params0, tp.nu)[4]
    assert (plan.segments is not None) == (demo == "ms_global")
    x = _walkers(np.asarray(jp.extract(jp.params0)),
                 np.random.default_rng(5), (T, C))
    (jl, jP), (jgl, _) = jax.jit(jp.batched_logparts_and_grad)(
        jnp.asarray(x))
    (tl, tP), (tgl, _) = tp.batched_logparts_and_grad(torch.as_tensor(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-5)
    assert np.abs(np.asarray(jgl)).max() > 0
    # subgiant_mixed: the float32 mixed-mode solver's (DPi1, eps_g, q)
    # gradients differ ~5e-4 between the packages before the likelihood
    # (tests/test_torch_sampler.py holds this family to 1e-3); the
    # likelihood itself is held to 1e-5 below, on given components
    assert _rel(tgl, jgl) <= (1e-5 if demo == "ms_global" else 1e-3)
    tl2, _ = tp.batched_log_parts(torch.as_tensor(x))
    np.testing.assert_array_equal(tl2.numpy(), tl.numpy())


@pytest.mark.parametrize("demo", sorted(DEMOS))
def test_fused_likelihood_of_given_components_matches_jax(demo):
    """The same components, background and spectrum through both
    packages' likelihood (the reference's segment_values and
    likelihood_chi22p_pieces on a segment plan, its sum_lorentzians and
    likelihood_chi22p on a dense one): logL within 1e-5 relative, the
    gradients in H, C, W, B and the white level within 1e-5 of each one's
    largest entry."""
    from tamcmc_tpu.ops import lorentzian as jl
    from tamcmc_tpu.stats import likelihoods as jlik
    jp, _, _, _ = j_make_demo(demo, seed=0, **DEMOS[demo])
    tp = convert.problem_from_reference(jp)
    x = _walkers(np.asarray(jp.extract(jp.params0)),
                 np.random.default_rng(9), (T * C,))
    with torch.no_grad():
        H, C_, W, B, plan, bg_n, bg_b = tp._chi22p_hook(
            tp.embed(torch.as_tensor(x)), tp.nu,
            fixed=(tp.params0, ~tp.priors.free_mask))
    args = [a.contiguous() for a in (H, C_, W, B, bg_b)]
    leaves = [a.clone().requires_grad_(True) for a in args]
    tl = L.lorentzian_chi22p(tp.nu, tp.spec, *leaves[:4], plan, bg_n,
                             leaves[4])
    tg = torch.autograd.grad(tl.sum(), leaves)
    jnu, jspec, jbg_n = (jnp.asarray(a.numpy()) for a in (tp.nu, tp.spec,
                                                          bg_n))

    def one(h, c, w, b, white):
        bg = jbg_n + white
        if plan.segments is not None:
            pieces = jl.segment_values(jnu, h, c, w, b, plan.segments)
            return jlik.likelihood_chi22p_pieces(
                jspec, pieces, lambda lo, hi: bg[lo:hi])
        return jlik.likelihood_chi22p(
            jspec, jl.sum_lorentzians(jnu, h, c, w, b) + bg)

    ja = [jnp.asarray(a.numpy()) for a in args]
    jlv, jg = jax.jit(jax.vmap(jax.value_and_grad(one, argnums=(0, 1, 2, 3,
                                                              4))))(*ja)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jlv),
                               rtol=1e-5)
    for got, want in zip(tg, jg):
        assert np.abs(np.asarray(want)).max() > 0
        assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# the plain version against the chain, and the kernel route's host side
# ---------------------------------------------------------------------------

def _problem(kind):
    """A small demo problem of `kind` and its walkers (T, C, Df)."""
    if kind == "stacked":
        stars = [t_make_demo("ms_global", seed=s, **DEMOS["ms_global"])[0]
                 for s in (0, 1)]
        p = stacked_problem(stars)
        x0 = np.stack([s.extract(s.params0).numpy() for s in stars])
        noise = np.random.default_rng(6).standard_normal(
            (2, T, C, x0.shape[-1]))
        x = x0[:, None, None] * (1 + 1e-4 * noise) + 1e-5 * noise
        return p, x.astype(np.float32)
    demo = "subgiant_mixed" if kind == "dense" else "ms_global"
    p = t_make_demo(demo, seed=0, **DEMOS[demo])[0]
    x0 = p.extract(p.params0).numpy()
    return p, _walkers(x0, np.random.default_rng(8), (T, C))


def _inputs(p, full, bg):
    """The hook's inputs with the background in form `bg`: "white" (the
    demos' split: fixed Harvey terms (N,), a free white level (..., 1)),
    "shared" (everything fixed: bg_n alone), "harvey" (a free Harvey term:
    bg_b (..., N) alone) or "floor" (every Harvey term absent and the white
    level clamped to 0, so that quiet bins have M = 0)."""
    hook = p.model_fn._chi22p_inputs
    if bg == "harvey":                  # nothing fixed: all per walker
        return hook(full, p.nu)
    free = p.priors.free_mask.copy()
    params0 = p.params0
    lo = p.layout.offset("noise")
    white = lo + p.layout.size("noise") - 1
    if bg == "shared":
        free[lo:white + 1] = False
    elif bg == "floor":
        params0 = params0.clone()
        params0[..., lo:white] = -1.0   # every Harvey term absent
        full = full.clone()
        full[..., white] = -1.0         # the white level clamped to 0
    return hook(full, p.nu, fixed=(params0, ~free))


def _chain(p, H, C_, W, B, plan, bg_n, bg_b, precision="f32"):
    """Today's chain: the mode sum over the grid plus the background,
    through likelihood_chi22p."""
    if plan.segments is not None:
        modes = L.sum_lorentzians_segments_plain(p.nu, H, C_, W, B,
                                                 plan.segments, precision)
    else:
        modes = L.sum_lorentzians_plain(p.nu, H, C_, W, B, precision)
    bg = L._background_sum(p.spec, bg_n, bg_b)
    return likelihood_chi22p(p.spec, modes + bg)


def _emulated_kernel(nu, spec, H, C_, W, B, bg_n, bg_b, plan):
    """The kernel's contract in torch on the flattened arguments it is
    handed: walker b reads spectrum row b // (Bt / rows)."""
    bt = H.shape[0]
    K._check_chi22p(nu, spec, bg_n, bg_b, bt)
    for t in (H, C_, W, B):
        assert t.is_contiguous() and tuple(t.shape) == (bt, plan.ncomp)
    row = torch.arange(bt) // (bt // spec.shape[0])
    if plan.segments is not None:
        modes = L.sum_lorentzians_segments_plain(nu, H, C_, W, B,
                                                 plan.segments,
                                                 plan.precision)
    else:
        modes = L.sum_lorentzians_plain(nu, H, C_, W, B, plan.precision)
    bg = torch.zeros(())
    if bg_n is not None:
        bg = bg_n[row]
    if bg_b is not None:
        bg = bg + (bg_b[:, None] if bg_b.ndim == 1 else bg_b)
    return likelihood_chi22p(spec[row], modes + bg)


CASES = [("segment", "white"), ("segment", "shared"), ("segment", "harvey"),
         ("segment", "floor"), ("dense", "white"), ("dense", "harvey"),
         ("stacked", "white"), ("stacked", "harvey")]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kind,bg", CASES)
def test_plain_version_is_the_chain(kind, bg, precision):
    p, x = _problem(kind)
    leaf = torch.tensor(x, requires_grad=True)
    H, C_, W, B, plan, bg_n, bg_b = _inputs(p, p.embed(leaf), bg)
    if precision == "bf16":
        plan = (K.segment_plan(plan.segments, plan.ncomp, plan.n_bins,
                               precision="bf16")
                if plan.segments is not None else
                K.dense_plan(plan.n_bins, plan.ncomp, precision="bf16"))
    want_shape = {"white": (1,), "shared": None, "harvey": (p.nu.shape[0],),
                  "floor": (1,)}[bg]
    assert (bg_b is None) == (want_shape is None)
    if bg_b is not None:
        assert tuple(bg_b.shape[-1:]) == want_shape
    got = L.lorentzian_chi22p(p.nu, p.spec, H, C_, W, B, plan, bg_n, bg_b,
                              precision)
    want = _chain(p, H, C_, W, B, plan, bg_n, bg_b, precision)
    assert got.shape == x.shape[:-1] and torch.isfinite(got).all()
    np.testing.assert_array_equal(got.detach().numpy(),
                                  want.detach().numpy())
    g1, = torch.autograd.grad(got.sum(), leaf, retain_graph=True)
    g2, = torch.autograd.grad(want.sum(), leaf)
    assert torch.isfinite(g1).all() and g1.abs().max() > 0
    np.testing.assert_array_equal(g1.numpy(), g2.numpy())
    if bg == "floor":
        with torch.no_grad():
            m = (L.sum_lorentzians_segments_plain(p.nu, H, C_, W, B,
                                                  plan.segments)
                 + L._background_sum(p.spec, bg_n, bg_b))
        assert (m == 0).any() and (m > 0).any()


@pytest.mark.parametrize("kind,bg", CASES)
def test_kernel_route_hands_the_kernel_its_rows(kind, bg, monkeypatch):
    """The CUDA route's flattening (walkers to (Bt, NC), the spectrum and
    bg_n to rows, bg_b to (Bt,) or (Bt, N)) with the kernel emulated."""
    p, x = _problem(kind)
    leaf = torch.tensor(x, requires_grad=True)
    H, C_, W, B, plan, bg_n, bg_b = _inputs(p, p.embed(leaf), bg)
    want = L.lorentzian_chi22p(p.nu, p.spec, H, C_, W, B, plan, bg_n, bg_b)
    gw, = torch.autograd.grad(want.sum(), leaf, retain_graph=True)
    seen = []

    def kernel(nu, spec, *rest):
        seen.append(spec.shape[0])
        return _emulated_kernel(nu, spec, *rest)

    monkeypatch.setattr(L, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(K, "lorentzian_chi22p_kernel", kernel)
    got = L.lorentzian_chi22p(p.nu, p.spec, H, C_, W, B, plan, bg_n, bg_b)
    assert seen == [2 if kind == "stacked" else 1]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6)
    gg, = torch.autograd.grad(got.sum(), leaf)
    assert _rel(gg, gw) <= 1e-6


def test_fused_entry_refuses_a_windowed_or_other_precision_plan():
    p, x = _problem("segment")
    H, C_, W, B, plan, bg_n, bg_b = _inputs(p, p.embed(torch.as_tensor(x)),
                                            "white")
    with pytest.raises(ValueError, match="segment or dense plan"):
        L.lorentzian_chi22p(p.nu, p.spec, H, C_, W, B, plan, bg_n, bg_b,
                            "bf16")
    win = K.dense_plan(plan.n_bins, plan.ncomp, windowed=True)
    with pytest.raises(ValueError, match="segment or dense plan"):
        L.lorentzian_chi22p(p.nu, p.spec, H, C_, W, B, win, bg_n, bg_b)


# ---------------------------------------------------------------------------
# the epilogue: per-bin arithmetic and its reduction order
# ---------------------------------------------------------------------------

def _epilogue(modes, spec, bg):
    """t and g per (walker, bin) as csrc/lorentzian.cu chi22p_epilogue forms
    them, in float32 numpy."""
    f = np.float32
    M = (modes.astype(f) + bg.astype(f)).astype(f)
    m = np.where(M < f(1e-12), f(1e-12), M).astype(f)
    q = (spec.astype(f) / m).astype(f)
    t = (np.log(m).astype(f) + q).astype(f)
    g = np.where(M >= f(1e-12), ((q / m).astype(f)
                                 - (f(1) / m).astype(f)).astype(f), f(0))
    return t, g.astype(f)


@pytest.mark.parametrize("bg", ["white", "floor", "harvey"])
def test_epilogue_formula_is_the_chains_gradient(bg):
    """-sum t is logL and g is autograd's dlogL/dM of the chain, the floor
    included (g = 0 where M < 1e-12)."""
    p, x = _problem("segment")
    H, C_, W, B, plan, bg_n, bg_b = _inputs(
        p, p.embed(torch.as_tensor(x)), bg)
    modes = L.sum_lorentzians_segments_plain(p.nu, H, C_, W, B,
                                             plan.segments).detach()
    back = L._background_sum(p.spec, bg_n, bg_b).detach()
    M = (modes + back).requires_grad_(True)
    logL = likelihood_chi22p(p.spec, M)
    dM, = torch.autograd.grad(logL.sum(), M)
    t, g = _epilogue(modes.numpy(), p.spec.numpy(),
                     np.broadcast_to(back.numpy(), modes.shape))
    np.testing.assert_allclose(-t.sum(-1, dtype=np.float64),
                               logL.detach().numpy(), rtol=1e-6)
    # each operation autograd's: g is its gradient bit for bit
    np.testing.assert_array_equal(g, dM.numpy())
    if bg == "floor":
        assert np.any(M.detach().numpy() < 1e-12)
        assert np.all(g[M.detach().numpy() < 1e-12] == 0)


def _gappy_plan(n, tile):
    """A segment plan whose segments leave gaps (a whole tile among them),
    with a ragged last tile."""
    segs = ((tuple(range(0, 3)), 50, 700),
            (tuple(range(3, 6)), n // 2, n // 2 + 100),
            (tuple(range(6, 8)), 4 * n // 5, n - 7))
    return K.segment_plan(segs, 8, n, tile=tile)


@pytest.mark.parametrize("n,tile", [(5000, K.FWD_TILE), (4097, K.FWD_TILE),
                                    (3001, 256), (40000, K.FWD_TILE)])
def test_epilogue_reduction_replay(n, tile):
    """Every bin lies in one tile of the plan (gap tiles list no component),
    and the records added in tile order give torch.sum's logL and sum of g
    within float32 reassociation."""
    plan = _gappy_plan(n, tile)
    assert plan.n_tiles == -(-n // tile) and n % tile
    empty = [s for s in range(plan.n_tiles)
             if plan.tile_ptr[s] == plan.tile_ptr[s + 1]]
    assert empty, "the grid must have a gap tile"
    rng = np.random.default_rng(n)
    bt = 6
    nu = torch.linspace(1000.0, 2000.0, n)
    H = torch.as_tensor(rng.uniform(1, 5, (bt, 8)), dtype=torch.float32)
    C_ = torch.as_tensor(rng.uniform(1050, 1900, (bt, 8)),
                         dtype=torch.float32)
    W = torch.as_tensor(rng.uniform(0.5, 3, (bt, 8)), dtype=torch.float32)
    B = torch.zeros((bt, 8))
    spec = torch.as_tensor(rng.exponential(1.0, n), dtype=torch.float32)
    white = torch.as_tensor(rng.uniform(0.5, 2.0, (bt, 1)),
                            dtype=torch.float32).requires_grad_(True)
    white.data[0] = 0.0              # walker 0: M = 0 on every quiet bin
    logL = L.lorentzian_chi22p(nu, spec, H, C_, W, B, plan, None, white)
    dwhite, = torch.autograd.grad(logL.sum(), white)
    modes = L.sum_lorentzians_segments_plain(nu, H, C_, W, B, plan.segments)
    t, g = _epilogue(modes.numpy(), spec.numpy(),
                     np.broadcast_to(white.detach().numpy(), modes.shape))
    ts, gs = K.chi22p_tile_sums(t, g, tile)
    assert ts.dtype == gs.dtype == np.float32
    np.testing.assert_allclose(-ts, logL.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(gs, torch.as_tensor(g).sum(-1).numpy(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(gs, dwhite[:, 0].numpy(), rtol=1e-5,
                               atol=1e-3)


def test_replay_adds_in_the_kernels_order():
    """The replay's order on values whose float32 sum depends on it: a
    thread's four bins, the warp's butterfly, the warps, then the tiles."""
    tile = K.FWD_TILE
    t = np.zeros((1, 2 * tile), np.float32)
    t[0, 0], t[0, 1] = 1e8, -1e8        # thread 0 of tile 0: cancel first
    t[0, 2] = 1.0
    t[0, tile] = 3.0                    # tile 1
    ts, _ = K.chi22p_tile_sums(t, t, tile)
    assert ts[0] == np.float32(4.0)
    # bins past N add nothing; an all-zero grid sums to zero
    ts, gs = K.chi22p_tile_sums(np.zeros((2, 10), np.float32),
                                np.ones((2, 10), np.float32), tile)
    assert ts.tolist() == [0.0, 0.0] and gs.tolist() == [10.0, 10.0]


def test_launch_keys_and_bound_of_the_fused_forward():
    assert K.launch_key("fwd_chi22p", "f32") == "fwd_chi22p"
    assert K.launch_key("fwd_chi22p", "bf16") == "fwd_chi22p_bf16"
    bt, nc, n, cb = 1280, 224, 120000, 3682749
    fwd, _ = K.bound_ms("fwd", bt, nc, n, cb)
    chi, by = K.bound_ms("fwd_chi22p", bt, nc, n, cb)
    extra = 1e3 * bt * n * (K.FLOPS_CHI22P / K.PEAK_F32
                            + K.MUFU_CHI22P / K.PEAK_MUFU)
    assert K.FLOPS_CHI22P == 11 and K.MUFU_CHI22P == 1
    assert by == "operations" and chi == pytest.approx(fwd + extra)
    # a small grid is bound by its bytes: g written, spec and bg_n read
    ms, by = K.bound_ms("fwd_chi22p", 4, 2, 10**6, 20)
    assert by == "bytes"
    assert ms == pytest.approx(
        1e3 * 4 * (10**6 * (1 + 4 + 2) + 4 * 4 * 2 + 4 + 4) / K.PEAK_BYTES)


def test_stacked_problem_routes_per_star_rows():
    """A stack of two stars hands the fused likelihood each star's
    spectrum and fixed background as one row, and its logL per star is the
    star's own problem's."""
    stars = [t_make_demo("ms_global", seed=s, **DEMOS["ms_global"])[0]
             for s in (0, 1)]
    p, x = _problem("stacked")
    H, C_, W, B, plan, bg_n, bg_b = p.model_fn._chi22p_inputs(
        p.embed(torch.as_tensor(x)), p.nu,
        fixed=(p.params0, ~p.priors.free_mask))
    assert tuple(bg_n.shape) == (2, 1, 1, p.nu.shape[0])
    assert tuple(bg_b.shape) == (2, T, C, 1)
    logL, _ = p.log_parts(torch.as_tensor(x))
    for s, star in enumerate(stars):
        star = dataclasses.replace(star, model_fn=p.model_fn)
        own, _ = star.log_parts(torch.as_tensor(x[s]))
        np.testing.assert_allclose(logL[s].numpy(), own.numpy(), rtol=1e-6)
