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
    torch.sum within 1e-5 relative;
  * the epilogue's quotients (csrc/lorentzian.cu quot_rcp3: one
    reciprocal, the product and two corrections by the residual, each fma
    rounded once) replayed in numpy: s / m and (s / m) / m equal the IEEE
    quotients bit for bit over every significand of m for numerators near
    1, near 2, beside midpoints and elsewhere, at the corners of the range
    where the fast path is proven, and past it (the IEEE divisions); and
    t and g through them at M below the floor, +inf, NaN and S = 0 against
    the chain (g bit for bit).
"""

import dataclasses
import pathlib
import re

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
    bg = np.broadcast_to(white.detach().numpy(), modes.shape)
    _, g = _epilogue(modes.numpy(), spec.numpy(), bg)
    # the kernel's t: per thread the sum of its bins' logarithms, then its
    # bins' quotients S / m (the IEEE ones)
    M = (modes.numpy() + bg).astype(np.float32)
    m = np.where(M < np.float32(1e-12), np.float32(1e-12), M)
    ts, gs = K.chi22p_tile_sums(spec.numpy() / m, g, tile,
                                _log_sums(m, tile))
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
    # a thread's head (its logarithms' sum) comes before its bins' terms
    head = np.zeros((1, 2 * tile // K.FWD_R), np.float32)
    head[0, 0] = 1e8
    t[0, 0], t[0, 1] = -1e8, 1.0
    ts, _ = K.chi22p_tile_sums(t, t, tile, head)
    assert ts[0] == np.float32(5.0)
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


# ---------------------------------------------------------------------------
# the epilogue's quotients: one reciprocal and two corrections
# ---------------------------------------------------------------------------

_CU = (pathlib.Path(__file__).resolve().parents[1] / "tamcmc_tpu_torch"
       / "csrc" / "lorentzian.cu").read_text()


def _cu_define(name):
    """A #define of csrc/lorentzian.cu as a float32 (a hex value is the
    bits of one)."""
    value = re.search(rf"#define {name} (\S+)", _CU).group(1)
    if value.startswith("0x"):
        return np.uint32(int(value.rstrip("u"), 16)).view(np.float32)
    return np.float32(value.rstrip("f"))


_LOW28 = np.uint64((1 << 28) - 1)


def _fma32(a, b, c):
    """fmaf(a, b, c) of float32 arrays, rounded once.  The product is exact
    in float64; the float64 sum's rounding error is kept exactly (two-sum),
    and a sum that lands on a float32 midpoint is settled by that error's
    sign, where rounding the float64 sum again would break the tie by
    evenness (double rounding)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    out = s.astype(np.float32)
    # a float32 midpoint has at most 25 significant bits
    tie = ((s.view(np.uint64) & _LOW28) == 0) & (err != 0)
    if tie.any():
        st, et, ft = s[tie], err[tie], out[tie]
        other = np.nextafter(ft, np.where(st > ft, np.float32(np.inf),
                                          np.float32(-np.inf)))
        mid = (ft.astype(np.float64) + other.astype(np.float64)) / 2
        flip = (st == mid) & ((et > 0) == (other > ft))
        out[tuple(i[flip] for i in np.nonzero(tie))] = other[flip]
    return out


def _quot_rcp(a, m, r):
    """csrc/lorentzian.cu quot_rcp: a r, then two corrections by the
    residual, each fma rounded once."""
    q = (a.astype(np.float64) * r.astype(np.float64)).astype(np.float32)
    for _ in range(2):
        q = _fma32(_fma32(-m, q, a), r, q)
    return q


def _quot_range(a):
    """|a| in [2^-78, 2^86]: the numerators for which the header proves
    quot_rcp exact (with m in [2^-40, 2^47])."""
    a = np.abs(np.asarray(a, np.float32))
    return (a >= np.float32(2.0 ** -78)) & (a <= np.float32(2.0 ** 86))


def _spec_in_range(s):
    """csrc/lorentzian.cu spec_in_range: |s| in [2^-31, 2^46], NaN out."""
    lo, hi = (_cu_define(k).view(np.uint32)
              for k in ("QUOT_S_LO", "QUOT_S_HI"))
    bits = np.asarray(s, np.float32).view(np.uint32) & np.uint32(0x7fffffff)
    return (bits - lo) <= (hi - lo)


def _quotients(s, m):
    """The epilogue's (1 / m, s / m, (s / m) / m): csrc/lorentzian.cu
    quot_rcp3 from r = the correctly rounded 1 / m (which rcp_nr is on the
    card for these m), and quot_ieee3, the IEEE divisions, where quot_fast
    does not hold."""
    s, m = np.broadcast_arrays(np.asarray(s, np.float32),
                               np.asarray(m, np.float32))
    with np.errstate(all="ignore"):
        r = np.float32(1) / m
        q = _quot_rcp(s, m, r)
        q2 = _quot_rcp(q, m, r)
        fast = (m <= _cu_define("QUOT_M_MAX")) & _spec_in_range(s)
        ieee = s / m
        return (np.where(fast, r, np.float32(1) / m), np.where(fast, q, ieee),
                np.where(fast, q2, ieee / m))


def _same_bits(a, b):
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


def _ulps(x, k):
    """x moved by k float32 ulps (toward +inf for k > 0)."""
    return (np.float32(x).view(np.uint32) + np.int64(k)).astype(
        np.uint32).view(np.float32)


_NUMERATORS = {
    "near 1": [1.0, _ulps(1.0, 1), _ulps(1.0, 2)],
    "near 2": [_ulps(2.0, -1), _ulps(2.0, -2), _ulps(2.0, -3)],
    "near midpoints": [_ulps(1.5, -1), _ulps(1.5, 1), _ulps(1.75, -1)],
    "spread": [4.0 / 3.0, 1.6180340, 0.371],
}


@pytest.mark.parametrize("group", sorted(_NUMERATORS))
def test_epilogue_quotients_are_the_ieee_quotients(group):
    """s / m and (s / m) / m on the epilogue's path (the reciprocal, its
    product and two corrections) equal the IEEE quotients bit for bit for
    every significand of m (2^23 values in [1, 2)), for numerators whose
    significands lie near 1, near 2, beside midpoints and elsewhere."""
    m_all = (np.arange(2 ** 23, dtype=np.uint32)
             | np.uint32(0x3F800000)).view(np.float32)
    r_all = np.float32(1) / m_all
    for s in _NUMERATORS[group]:
        # s / m lies in (s / 2, s]: the fast path's range for both
        assert _quot_range(np.float32([s, np.float32(s) / 2])).all()
        for lo in range(0, m_all.size, 2 ** 16):     # cache-sized slices
            m, r = m_all[lo:lo + 2 ** 16], r_all[lo:lo + 2 ** 16]
            a = np.full(m.shape, np.float32(s))
            want = a / m
            assert _same_bits(_quot_rcp(a, m, r), want), (s, lo)
            assert _same_bits(_quot_rcp(want, m, r), want / m), (s, lo)


def test_epilogue_quotients_at_the_range_ends():
    """The proof scales the significands' result by powers of two while r,
    the quotient and the residual stay normal: random significand pairs at
    the four corners of the proven range (numerator 2^-78 or 2^85 times a
    significand, m at the floor's binade or 2^46 times one) still give the
    IEEE quotients; the kernel's test on S (|S| in [2^-31, 2^46]) keeps
    both numerators in that range; past its ends (a zero, subnormal or
    huge numerator, m above 2^47, +inf, NaN) the IEEE divisions run, so the
    three results are the IEEE ones everywhere."""
    rng = np.random.default_rng(12)
    sig = (rng.integers(0, 2 ** 23, (2, 4096), dtype=np.uint32)
           | np.uint32(0x3F800000)).view(np.float32)
    m_max = _cu_define("QUOT_M_MAX")
    assert m_max == np.float32(2.0 ** 47)
    # the kernel's test on S keeps both numerators, S and S / m, in range
    ends = np.float32([2.0 ** -31, 2.0 ** 46, -(2.0 ** 46)])
    assert _spec_in_range(ends).all()
    assert not _spec_in_range(np.nextafter(ends, np.float32(0))[:1]).any()
    assert not _spec_in_range(np.nextafter(ends[1:], np.float32(
        np.inf) * np.sign(ends[1:]))).any()
    for m in (np.float32(1e-12), m_max):
        assert _quot_range(ends / m).all()
    for a_exp in (-78, 85):
        for m_exp in (-39, 46):
            a = sig[0] * np.float32(2.0 ** a_exp)
            m = sig[1] * np.float32(2.0 ** m_exp)
            assert (m >= np.float32(1e-12)).all() and (m <= m_max).all()
            r = np.float32(1) / m
            want = a / m
            assert _quot_range(a).all()
            assert (np.abs(want) >= np.float32(2.0 ** -125)).all()
            assert _same_bits(_quot_rcp(a, m, r), want)
            ok = _quot_range(want)
            assert _same_bits(_quot_rcp(want[ok], m[ok], r[ok]),
                              want[ok] / m[ok])
    nums = np.array([0.0, -0.0, 1e-40, _ulps(2.0 ** -31, -1), 2.0 ** -31,
                     2.0 ** 46, _ulps(2.0 ** 46, 1), 3e38, -1.75, 1.3,
                     np.inf, np.nan], np.float32)
    ms = np.array([1e-12, 0.37, 1.0, 3.7, m_max, _ulps(m_max, 1),
                   2.0 ** 125, np.inf, np.nan], np.float32)
    s, m = np.meshgrid(nums, ms)
    r, q, q2 = _quotients(s, m)
    with np.errstate(all="ignore"):
        want = s / m
        for got, ieee in ((r, np.float32(1) / m), (q, want),
                          (q2, want / m)):
            nan = np.isnan(ieee)
            assert (np.isnan(got) == nan).all()
            assert _same_bits(got[~nan], ieee[~nan])


def test_epilogue_one_reciprocal_keeps_the_chains_gradient():
    """The epilogue's t and g through its quotients, at M below the floor
    (and 0, negative), at the floor, +inf, NaN and S = 0: g is autograd's
    dlogL/dM of the chain bit for bit and t = ln m + S / m the chain's
    term (its quotient bit for bit)."""
    M = np.array([-5.0, 0.0, 1e-13, 1e-12, 2e-12, 0.5, 1.0, 37.5, 3e30,
                  np.inf, np.nan], np.float32)
    S = np.array([0.0, 1.3, 2.0 ** -80, 6.1], np.float32)
    M, S = (a.ravel() for a in np.meshgrid(M, S))
    m = np.where(M < np.float32(1e-12), np.float32(1e-12), M)
    r, q, q2 = _quotients(S, m)
    with np.errstate(all="ignore"):
        g = np.where(M >= np.float32(1e-12), (q2 - r).astype(np.float32),
                     np.float32(0))
        t = (np.log(m) + q).astype(np.float32)
    Mt = torch.as_tensor(M).requires_grad_(True)
    logL = likelihood_chi22p(torch.as_tensor(S), Mt)
    dM, = torch.autograd.grad(logL, Mt)
    assert _same_bits(g, dM.numpy())
    mt = torch.as_tensor(m)
    want_q = (torch.as_tensor(S) / mt).numpy()
    nan = np.isnan(want_q)
    assert (np.isnan(q) == nan).all() and _same_bits(q[~nan], want_q[~nan])
    want_t = (torch.log(mt).numpy() + want_q).astype(np.float32)
    tn = np.isnan(want_t)
    assert (np.isnan(t) == tn).all()
    np.testing.assert_allclose(t[~tn], want_t[~tn], rtol=1.2e-7)
    assert np.isinf(t[np.isinf(M)]).all() and (g[np.isinf(M)] == 0).all()
    assert (g[np.isnan(M)] == 0).all()


def _log_sums(m, tile):
    """csrc/lorentzian.cu log_sum of each forward thread's FWD_R bins of m
    (Bt, N) float32, finite and >= 1e-12; bins past N count as m = 1 (ln 1
    = 0): the product of the significands in order, the exponents' sum,
    logf (here the correctly rounded logarithm) and one fma with ln 2 in
    float32.  Returns (Bt, threads of the grid)."""
    bt, n = m.shape
    pad = np.ones((bt, -(-n // tile) * tile), np.float32)
    pad[:, :n] = m
    u = pad.reshape(bt, -1, K.FWD_R).view(np.uint32)
    sig = ((u & np.uint32(0x7FFFFF)) | np.uint32(0x3F800000)).view(
        np.float32)
    p = sig[..., 0]
    for r in range(1, K.FWD_R):
        p = p * sig[..., r]                 # float32, rounded each time
    e = (u >> np.uint32(23)).astype(np.int64).sum(-1) - 127 * K.FWD_R
    logp = np.log(p.astype(np.float64)).astype(np.float32)
    return _fma32(e.astype(np.float32), np.full(e.shape, _cu_define("LN2")),
                  logp)


def test_log_sum_within_its_bound():
    """One logarithm for a thread's four bins (log_sum) against float64's
    sum of the four: within the header's bound, 3 x 2^-24 + 2^-22 + |E| x
    2e-9 + half an ulp of the result (E the exponents' sum), over m from
    the floor 1e-12 to 2^47, clustered near 1 and equal."""
    assert abs(float(_cu_define("LN2")) - np.log(2.0)) < 2e-9
    rng = np.random.default_rng(7)
    wide = np.exp(rng.uniform(np.log(1e-12), np.log(2.0 ** 47),
                              (4096, 64))).astype(np.float32)
    near1 = (1 + rng.normal(0, 1e-3, (4096, 64))).astype(np.float32)
    equal = np.repeat(wide[:, :16], 4, axis=1)
    floor = np.full((16, 64), np.float32(1e-12))
    for m in (wide, near1, equal, floor):
        got = _log_sums(m, m.shape[1]).astype(np.float64)
        want = np.log(m.astype(np.float64)).reshape(
            m.shape[0], -1, K.FWD_R).sum(-1)
        u = m.reshape(m.shape[0], -1, K.FWD_R).view(np.uint32)
        e = (u >> np.uint32(23)).astype(np.int64).sum(-1) - 127 * K.FWD_R
        bound = (3 * 2.0 ** -24 + 2.0 ** -22 + np.abs(e) * 2e-9
                 + 0.5 * np.spacing(np.abs(got).astype(np.float32)))
        assert (np.abs(got - want) <= bound).all()
