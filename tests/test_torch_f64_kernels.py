"""The float64 instantiation of the Lorentzian kernels, on the CPU.

On the card `run --precision f64` runs lorentz_fwd_f64, lorentz_fwd_chi22p_f64
and lorentz_bwd_f64 (csrc/lorentzian.cu); no CUDA kernel runs here, so
their order of work is replayed in numpy float64, every operation rounded
once as the kernels round it, and held against the JAX package under
`jax.enable_x64(True)` on the same inputs (a float32 draw cast to double,
as an f64 fit's data is):

  * the forward's tile walk (per 1024-bin tile, the components that cover
    the tile first, their h b^2 once per walker, the rest masked per bin)
    in segment and dense mode against `sum_lorentzians_segments` /
    `sum_lorentzians` (`_fwd_impl`): within 1e-12 relative;
  * the chi22p epilogue (g per bin; t per thread, the one logarithm of its
    four bins, lorentzian_kernel.log_sums_f64, then their quotients S / m;
    per-(walker, tile) records added in tile order,
    lorentzian_kernel.chi22p_tile_sums) against
    `likelihood_chi22p_pieces` / `likelihood_chi22p` and jax.grad of it:
    logL within 1e-12 relative, g within 1e-12 of its max;
  * the backward's per-(component, chunk) records (lane-strided sums, the
    xor butterfly), added in chunk order, and the closed form against
    jax.vjp: within 1e-11 of each gradient's max;
  * the float64 backward's chunk and shared memory at the five
    configurations' shapes, bound_ms in float64 against a hand count, and
    the dtype routing: the float64 launch keys, a float32/float64 mix and a
    float64 windowed or bf16 plan refused, the main path handing the kernel
    route float64 tensors only.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.ops import lorentzian as jl
from tamcmc_tpu.stats import likelihoods as jlik
from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.ops import lorentzian as L
from tamcmc_tpu_torch.ops import lorentzian_kernel as K

torch.set_num_threads(1)

VAL, GRAD = 1e-12, 1e-11
BT, NC, N = 6, 24, 3 * 1024 + 200      # three tiles and a ragged tail


def _case(seed=5):
    """A float32 draw cast to double: nu (N,), (H, C, W, B) (Bt, NC), an
    upstream gradient, a spectrum, the background split (bg_n (N,), bg_b
    (Bt, 1)) and the window partition of walker 0's centres."""
    rng = np.random.default_rng(seed)

    def f64(a):
        return np.asarray(a, np.float32).astype(np.float64)
    nu = f64(np.linspace(1000.0, 1200.0, N))
    H = f64(rng.uniform(1, 10, (BT, NC)))
    C = f64(rng.uniform(1010, 1190, (BT, NC)))
    W = f64(rng.uniform(0.5, 3.0, (BT, NC)))
    B = f64(rng.uniform(-0.05, 0.05, (BT, NC)))
    g = f64(rng.normal(size=(BT, N)))
    spec = f64(rng.exponential(2.0, N))
    bg_n = f64(0.5 + 0.2 * np.cos(nu / 30.0))
    bg_b = f64(rng.uniform(0.1, 0.3, (BT, 1)))
    segs = jl.partition_window_groups(jl.make_static_window_groups(
        C[0], 20.0 * W[0] + 2.0, float(nu[0]), float(nu[1] - nu[0]), N))
    return nu, (H, C, W, B), g, spec, bg_n, bg_b, segs


def _plan(form, segs):
    return K.segment_plan(segs, NC, N) if form == "segments" else \
        K.dense_plan(N, NC)


def _profile(nu, c, iw, h, hb2):
    """x, 1 / (1 + x^2) and (h + 2hb x) / (1 + x^2), each op rounded once
    (csrc/lorentzian.cu x_f64, inv_f64)."""
    x = (nu - c) * iw
    inv = 1.0 / (1.0 + x * x)
    return x, inv, (h + hb2 * x) * inv


def _fwd_replay(plan, nu, H, C, W, B):
    """(Bt, N) modes as lorentz_fwd_f64_kernel sums them: per tile, the
    tile's list in order; a covering component adds v to each bin and h b^2
    once to the walker's constant, a partial one h b^2 + v to each bin of
    its range; the store adds the constant."""
    iw = 2.0 / np.maximum(W, 1e-6)
    hb2, hbb = (2.0 * H) * B, (H * B) * B
    out = np.zeros((H.shape[0], plan.n_bins))
    for t in range(plan.n_tiles):
        bins = np.arange(t * plan.tile, min((t + 1) * plan.tile, plan.n_bins))
        acc = np.zeros((H.shape[0], bins.size))
        cst = np.zeros((H.shape[0], 1))
        pf = plan.tile_full[t]
        for p in range(plan.tile_ptr[t], plan.tile_ptr[t + 1]):
            k = plan.tile_comp[p]
            sl = slice(k, k + 1)
            v = _profile(nu[bins], C[:, sl], iw[:, sl], H[:, sl],
                         hb2[:, sl])[2]
            if p < pf:
                cst = cst + hbb[:, sl]
                acc = acc + v
            else:
                inr = (bins >= plan.comp_lo[k]) & (bins < plan.comp_hi[k])
                acc = acc + np.where(inr, hbb[:, sl] + v, 0.0)
        out[:, bins] = acc + cst
    return out


def _epilogue_replay(modes, spec, bg):
    """logL, g and sum g as lorentz_fwd_f64_chi22p_kernel forms them from
    the modes and the background bg = bg_n + bg_b: a thread's t starts from
    the one logarithm of its four bins (lorentzian_kernel.log_sums_f64),
    then adds their quotients S / m in order."""
    M = modes + bg
    m = np.where(M < 1e-12, 1e-12, M)
    q = spec / m
    g = np.where(M >= 1e-12, q / m - 1.0 / m, 0.0)
    T, G = K.chi22p_tile_sums(q, g, head=K.log_sums_f64(m),
                              dtype=np.float64)
    return -T, g, G


def _bwd_replay(plan, nu, H, C, W, B, g):
    """(gH, gC, gW, gB) as lorentz_bwd_f64_kernel forms them on `plan` (the
    forward's plan for_walkers(Bt, float64)): per (walker, chunk, slot) the
    six sums over the slot's bins, lane l taking bins start + l, start + l
    + 32, ..., then the xor butterfly; per component its records in chunk
    order; the closed form."""
    bt = H.shape[0]
    iw = 2.0 / np.maximum(W, 1e-6)
    recs = np.zeros((bt, plan.n_slots, 6))
    idx = np.arange(32)
    for ch in range(plan.n_chunks):
        c0 = ch * plan.chunk
        length = min(plan.chunk, plan.n_bins - c0)
        for s in range(plan.chunk_ptr[ch], plan.chunk_ptr[ch + 1]):
            k = plan.chunk_comp[s]
            start = max(plan.comp_lo[k] - c0, 0)
            end = min(plan.comp_hi[k] - c0, length)
            bins = c0 + np.arange(start, end)
            sl = slice(k, k + 1)
            x, inv, _ = _profile(nu[bins], C[:, sl], iw[:, sl], 0.0, 0.0)
            gb = g[:, bins]
            u = gb * inv
            p = x * u
            q = p * inv
            r = x * q
            vals = np.stack([gb, u, p, q, r, x * r], axis=1)
            steps = -(-bins.size // 32)
            lanes = np.zeros((bt, 6, steps * 32))
            lanes[..., :bins.size] = vals
            lanes = lanes.reshape(bt, 6, steps, 32)
            acc = np.zeros((bt, 6, 32))
            for i in range(steps):
                acc = acc + lanes[:, :, i]
            for off in (16, 8, 4, 2, 1):
                acc = acc + acc[..., idx ^ off]
            recs[:, s] = acc[..., 0]
    sums = np.zeros((bt, NC, 6))
    for k in range(NC):
        for slot in plan.comp_slot[plan.comp_ptr[k]:plan.comp_ptr[k + 1]]:
            sums[:, k] = sums[:, k] + recs[:, slot]
    Gk, Su, Sp, Sq, Sr, Ss = np.moveaxis(sums, -1, 0)
    w = np.maximum(W, 1e-6)
    iw = 2.0 / w
    hb2 = 2.0 * H * B
    gH = B * B * Gk + Su + 2.0 * B * Sp
    gB = hb2 * Gk + 2.0 * H * Sp
    dx = hb2 * Su - 2.0 * H * Sq - 2.0 * hb2 * Sr
    dxx = hb2 * Sp - 2.0 * H * Sr - 2.0 * hb2 * Ss
    gW = np.where(W > 1e-6, -dxx / w, 0.0)
    return gH, -iw * dx, gW, gB


def _jax_modes(form, nu, segs):
    jnu = jnp.asarray(nu)
    if form == "segments":
        return jax.vmap(lambda *r: jl.sum_lorentzians_segments(jnu, *r,
                                                               segs))
    return jax.vmap(lambda *r: jl.sum_lorentzians(jnu, *r))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("form", ["segments", "dense"])
def test_forward_and_epilogue_replays_match_jax_x64(form):
    nu, args, _, spec, bg_n, bg_b, segs = _case()
    plan = _plan(form, segs)
    assert plan.n_tiles == 4 and (form == "dense" or len(segs) > 3)
    modes = _fwd_replay(plan, nu, *args)
    bg = bg_n + bg_b
    logL, g, gsum = _epilogue_replay(modes, spec, bg)
    with jax.enable_x64(True):
        jargs = [jnp.asarray(a) for a in args]
        want = np.asarray(jax.jit(_jax_modes(form, nu, segs))(*jargs))
        jspec, jbg = jnp.asarray(spec), jnp.asarray(bg)
        if form == "segments":
            jnu = jnp.asarray(nu)

            def lik(*r):
                *p, b = r
                return jlik.likelihood_chi22p_pieces(
                    jspec, jl.segment_values(jnu, *p, segs),
                    lambda lo, hi: b[lo:hi])
            want_logL = np.asarray(jax.jit(jax.vmap(lik))(*jargs, jbg))
        else:
            want_logL = np.asarray(jax.vmap(
                lambda m: jlik.likelihood_chi22p(jspec, m))(
                    jnp.asarray(want) + jbg))
        want_g = np.asarray(jax.grad(lambda m: jnp.sum(jax.vmap(
            lambda r: jlik.likelihood_chi22p(jspec, r))(m)))(
                jnp.asarray(modes + bg)))
        assert want.dtype == np.float64
    assert np.abs(modes - want).max() <= VAL * np.abs(want).max()
    assert np.all(np.abs(logL - want_logL) <= VAL * np.abs(want_logL))
    assert _rel(g, want_g) <= VAL
    assert np.allclose(gsum, want_g.sum(axis=-1), rtol=1e-11, atol=0.0)


@pytest.mark.parametrize("form", ["segments", "dense"])
def test_backward_replay_matches_jax_vjp_x64(form):
    nu, args, g, _, _, _, segs = _case(seed=6)
    plan = _plan(form, segs).for_walkers(BT, torch.float64)
    # ranges longer than a chunk and a ragged last chunk
    assert plan.chunk == K.BWD_MIN_CHUNK and N % plan.chunk
    assert plan.itemsize == 8 and plan.n_chunks == -(-N // plan.chunk)
    got = _bwd_replay(plan, nu, *args, g)
    with jax.enable_x64(True):
        def grads(g_, *a):
            return jax.vjp(_jax_modes(form, nu, segs), *a)[1](g_)
        want = [np.asarray(x) for x in jax.jit(grads)(
            jnp.asarray(g), *[jnp.asarray(a) for a in args])]
    for a, b in zip(got, want):
        assert b.dtype == np.float64 and _rel(a, b) <= GRAD


# (n_bins, walkers) of the five configurations (PERF.md section 4):
# ms_global, kepler_full, subgiant_mixed, the ajAlm file, the MS_local file
@pytest.mark.parametrize("n_bins,bt", [(40000, 768), (120000, 1280),
                                       (60000, 1024), (120000, 1280),
                                       (22466, 768)])
def test_float64_backward_plan_fits_shared_memory(n_bins, bt):
    plan = K.dense_plan(n_bins, 3)
    p32, p64 = plan.for_walkers(bt), plan.for_walkers(bt, torch.float64)
    # the float64 chunk stages doubles in the float32 chunk's bytes
    assert p64.itemsize == 8 and p64.chunk == p32.chunk // 2
    assert p64.bwd_smem_bytes == 2 * 8 * p64.chunk == p32.bwd_smem_bytes
    assert p64.bwd_smem_bytes <= K.SMEM_BUDGET and p64.chunk % 4 == 0
    assert p64 is plan.for_walkers(bt, torch.float64)          # cached
    assert np.array_equal(p64.tile_comp, plan.tile_comp)
    assert K.bwd_scratch(p64, 2, "cpu").dtype == torch.float64
    assert K.bwd_scratch(p32, 2, "cpu").dtype == torch.float32


def test_float64_bound_is_the_hand_count():
    """ms_global's slice: 768 walkers x 536,675 component-bins x 9 / 15
    operations over 33.5 TFLOP/s; the fused forward adds 11 + 1 (the
    logarithm) a walker-bin; 8 bytes a value."""
    bt, nc, n, cb = 768, 54, 40000, 536675
    for kind, flops in (("fwd", 9), ("bwd", 15)):
        ms, by = K.bound_ms(kind, bt, nc, n, cb, precision="f64")
        assert by == "operations"
        assert ms == pytest.approx(1e3 * flops * bt * cb / 33.5e12,
                                   rel=1e-12)
    assert K.bound_ms("fwd", bt, nc, n, cb, precision="f64")[0] == \
        pytest.approx(0.1107, abs=1e-4)
    ms, _ = K.bound_ms("fwd_chi22p", bt, nc, n, cb, precision="f64")
    assert ms == pytest.approx(1e3 * (9 * bt * cb + 12 * bt * n) / 33.5e12,
                               rel=1e-12)
    # bytes: eight a value, read once and written once
    ms, by = K.bound_ms("fwd", 1, nc, n, 1, precision="f64")
    assert by == "bytes" and ms == pytest.approx(
        1e3 * 8 * (n + n + 4 * nc) / 3.35e12, rel=1e-12)


def test_routing_picks_the_float64_kernels_and_refuses_a_mix():
    plan = K.dense_plan(64, 3)
    keys = [K.launch_key(k, K.stream_precision(plan, torch.float64))
            for k in ("fwd", "bwd", "fwd_chi22p")]
    assert keys == ["fwd_f64", "bwd_f64", "fwd_chi22p_f64"]
    assert K.stream_precision(plan, torch.float32) == "f32"
    nu = torch.linspace(0.0, 1.0, 64, dtype=torch.float64)
    p64 = tuple(torch.ones(2, 3, dtype=torch.float64) for _ in range(4))
    K.check_types(nu, p64, None, plan)
    K.check_types(nu.float(), tuple(t.float() for t in p64), None, plan)
    with pytest.raises(ValueError, match="one floating type"):
        K.check_types(nu, p64[:3] + (p64[3].float(),), None, plan)
    with pytest.raises(ValueError, match="one floating type"):
        K.check_types(nu.float(), p64, None, plan)
    with pytest.raises(ValueError, match="float32 only"):
        K.check_types(nu, p64, p64[0], K.dense_plan(64, 3, windowed=True))
    with pytest.raises(ValueError, match="bf16"):
        K.check_types(nu, p64, None, K.dense_plan(64, 3, precision="bf16"))
    with pytest.raises(ValueError, match="segment and dense modes"):
        K.dense_plan(64, 3, windowed=True).for_walkers(2, torch.float64)


@pytest.mark.parametrize("demo", ["ms_global", "subgiant_mixed"])
def test_f64_problem_hands_the_kernel_route_float64_only(demo, monkeypatch):
    """An f64 problem's step, routed as on a CUDA device (the kernel
    emulated by the plain version): every tensor the fused likelihood's
    kernel receives is float64, and so is what comes back."""
    seen = []

    def kernel(nu, spec, H, C_, W, B, bg_n, bg_b, plan):
        seen.append([t for t in (nu, spec, H, C_, W, B, bg_n, bg_b)
                     if t is not None])
        rows = spec.shape[0]
        per = H.shape[0] // rows
        return L.lorentzian_chi22p_plain(
            nu, spec.repeat_interleave(per, 0), H, C_, W, B, plan,
            None if bg_n is None else bg_n.repeat_interleave(per, 0),
            None if bg_b is None else (bg_b[:, None] if bg_b.ndim == 1
                                       else bg_b))

    problem = make_demo(demo, seed=0, ngrid=2000, n_orders=2)[0].astype(
        torch.float64)
    monkeypatch.setattr(L, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(K, "lorentzian_chi22p_kernel", kernel)
    x = problem.extract(problem.params0)[None].expand(3, -1).contiguous()
    (logL, logP), (gradL, gradP) = problem.logparts_and_grad(x)
    assert seen and all(t.dtype == torch.float64 for ts in seen for t in ts)
    for out in (logL, logP, gradL, gradP):
        assert out.dtype == torch.float64 and torch.isfinite(out).all()
