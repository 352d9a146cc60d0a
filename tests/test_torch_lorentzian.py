"""The PyTorch port's Lorentzian ops against the JAX reference.

Every input is made once with numpy from a seed and fed to both packages.
On the CPU the port runs its plain torch versions; the JAX windowed entry
`sum_lorentzians_trunc_batched` falls back to `sum_lorentzians_trunc` there.
The CUDA kernels themselves are checked on the card by chip_smoke.py; here
their host-side plan (ranges, forward tiles, backward chunks and slots) is
checked by replaying the kernels' traversal in numpy.

Tolerances (float32): values rtol 2e-5, atol 1e-5; gradients rtol 3e-3,
atol 3e-4 (the reference's tests/test_pallas.py bounds: the closed-form
reductions sum in a different order in each framework).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.ops import lorentzian as jl
from tamcmc_tpu.ops.pallas_lorentzian import \
    sum_lorentzians_trunc_batched as j_trunc_batched
from tamcmc_tpu_torch.ops import lorentzian as tl
from tamcmc_tpu_torch.ops import lorentzian_kernel as tk
from tamcmc_tpu_torch.utils.metrics import COUNTERS

torch.set_num_threads(1)

VAL = dict(rtol=2e-5, atol=1e-5)
GRAD = dict(rtol=3e-3, atol=3e-4)


def _mk(bt=3, nc=7, n=513, seed=0):
    """tests/test_pallas.py::_mk shapes, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    nu = np.array(jnp.linspace(90.0, 110.0, n))
    H = rng.uniform(1, 5, (bt, nc)).astype(np.float32)
    C = rng.uniform(94, 106, (bt, nc)).astype(np.float32)
    W = rng.uniform(0.3, 2, (bt, nc)).astype(np.float32)
    B = rng.uniform(-0.1, 0.1, (bt, nc)).astype(np.float32)
    g = rng.normal(size=(bt, n)).astype(np.float32)
    return nu, (H, C, W, B), g


def _jax_val_grad(fn, args, g):
    val = np.asarray(fn(*args))
    grads = jax.grad(lambda *a: jnp.sum(g * fn(*a)), argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in args])
    return val, [np.asarray(x) for x in grads]


def _torch_val_grad(fn, args, g):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.as_tensor(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _assert_pair(got, want):
    np.testing.assert_allclose(got[0], want[0], **VAL)
    for a, b, name in zip(got[1], want[1], "HCWB"):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD)


def test_sum_lorentzians_dense_matches_jax():
    nu, args, g = _mk()
    jnu = jnp.asarray(nu)
    want = _jax_val_grad(
        lambda *a: jax.vmap(lambda *r: jl.sum_lorentzians(jnu, *r))(*a),
        args, g)
    got = _torch_val_grad(
        lambda *a: tl.sum_lorentzians(torch.as_tensor(nu), *a), args, g)
    _assert_pair(got, want)


@pytest.mark.parametrize("window", ["finite", "inf", "negative"])
@pytest.mark.parametrize("entry", ["trunc", "trunc_batched"])
def test_windowed_sum_matches_jax(window, entry):
    nu, args, g = _mk()
    W = args[2]
    win = {"finite": 10.0 * W, "inf": np.full_like(W, np.inf),
           "negative": np.full_like(W, -1.0)}[window]
    jfn = jl.sum_lorentzians_trunc if entry == "trunc" else j_trunc_batched
    tfn = tl.sum_lorentzians_trunc if entry == "trunc" \
        else tl.sum_lorentzians_trunc_batched
    want = _jax_val_grad(
        lambda *a: jfn(jnp.asarray(nu), *a, jnp.asarray(win)), args, g)
    got = _torch_val_grad(
        lambda *a: tfn(torch.as_tensor(nu), *a, torch.as_tensor(win)),
        args, g)
    _assert_pair(got, want)
    if window == "negative":
        assert not np.any(got[0])
    if window == "inf":        # the +inf window is the dense sum
        dense = tl.sum_lorentzians(torch.as_tensor(nu),
                                   *map(torch.as_tensor, args))
        np.testing.assert_allclose(got[0], dense.numpy(), **VAL)


def _random_groups(seed, n_bins, ncomp):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(10.0, 90.0, ncomp)
    halfwidths = rng.uniform(0.5, 6.0, ncomp)
    return centers, halfwidths, 5.0, 0.25, n_bins


# from a few sparse groups to crowded grids where the 64-component group cap
# and off-grid clipping bind
@pytest.mark.parametrize("seed,n_bins,ncomp", [(0, 400, 12), (1, 400, 12),
                                               (2, 400, 200), (3, 200, 300)])
def test_window_groups_equal_jax(seed, n_bins, ncomp):
    args = _random_groups(seed, n_bins, ncomp)
    jg = jl.make_static_window_groups(*args)
    tg = tl.make_static_window_groups(*args)
    assert tg == jg
    assert tl.partition_window_groups(tg) == jl.partition_window_groups(jg)


def _segment_case(seed=0, bt=3, n=400, ncomp=12):
    """Random components on a uniform grid, windowed into a partition."""
    rng = np.random.default_rng(seed)
    nu = (5.0 + 0.25 * np.arange(n)).astype(np.float32)
    C = rng.uniform(10.0, 90.0, (bt, ncomp)).astype(np.float32)
    H = rng.uniform(1, 5, (bt, ncomp)).astype(np.float32)
    W = rng.uniform(0.3, 2, (bt, ncomp)).astype(np.float32)
    B = rng.uniform(-0.1, 0.1, (bt, ncomp)).astype(np.float32)
    segs = jl.partition_window_groups(jl.make_static_window_groups(
        C[0], 8.0 + 5.0 * W[0], 5.0, 0.25, n, new_group_cost_bins=16))
    g = rng.normal(size=(bt, n)).astype(np.float32)
    return nu, (H, C, W, B), segs, g


def test_segments_match_jax():
    nu, args, segs, g = _segment_case()
    assert len(segs) > 3 and any(len(s[0]) > 1 for s in segs)
    jnu = jnp.asarray(nu)

    def j_full(*a):           # the reference is unbatched: one walker a row
        return jnp.stack([jl.sum_lorentzians_segments(
            jnu, *(x[i] for x in a), segs) for i in range(a[0].shape[0])])

    want = _jax_val_grad(j_full, args, g)
    got = _torch_val_grad(lambda *a: tl.sum_lorentzians_segments(
        torch.as_tensor(nu), *a, segs), args, g)
    _assert_pair(got, want)

    pieces = tl.segment_values(torch.as_tensor(nu),
                               *map(torch.as_tensor, args), segs)
    assert [(lo, hi) for lo, hi, _ in pieces] == [(lo, hi)
                                                  for _, lo, hi in segs]
    for i in range(args[0].shape[0]):
        jp = jl.segment_values(jnu, *(jnp.asarray(x[i]) for x in args), segs)
        for (lo, hi, tv), (_, _, jv) in zip(pieces, jp):
            np.testing.assert_allclose(tv[i].numpy(), np.asarray(jv), **VAL)


def test_segment_plan_covers_each_pair_once():
    _, args, segs, _ = _segment_case(n=1000, ncomp=30)
    ncomp = args[0].shape[1]
    plan = tk.segment_plan(segs, ncomp, 1000, tile=64, chunk=96)
    want = sorted((k, n) for idx, lo, hi in segs for k in idx
                  for n in range(lo, hi))
    got = []
    for t in range(plan.n_tiles):           # the forward kernel's traversal
        bins = range(t * plan.tile, min((t + 1) * plan.tile, 1000))
        for p in range(plan.tile_ptr[t], plan.tile_ptr[t + 1]):
            k = int(plan.tile_comp[p])
            if p < plan.tile_full[t]:       # whole tile, no range test
                got.extend((k, n) for n in bins)
            else:
                got.extend((k, n) for n in bins
                           if plan.comp_lo[k] <= n < plan.comp_hi[k])
    assert sorted(got) == want and len(set(got)) == len(got)
    assert _bwd_pairs(plan) == want         # the backward's, slot by slot
    assert plan.comp_bins() == len(want)


def test_segment_plan_rejects_non_adjacent_segments():
    segs = (((0, 1), 0, 10), ((1,), 10, 20), ((0,), 30, 40))
    with pytest.raises(ValueError, match="non-adjacent"):
        tk.segment_plan(segs, 2, 50)


def _slot_range(plan, ch, s):
    """Bins [start, end) of chunk `ch`, relative to its first bin, that the
    backward's first kernel reduces for slot `s`."""
    c0 = ch * plan.chunk
    ln = min(plan.chunk, plan.n_bins - c0)
    if s < plan.chunk_full[ch]:             # covers the whole chunk
        return c0, 0, ln
    k = plan.chunk_comp[s]
    return (c0, max(int(plan.comp_lo[k]) - c0, 0),
            min(int(plan.comp_hi[k]) - c0, ln))


def _bwd_pairs(plan):
    """Sorted (component, bin) pairs the backward's slots reduce."""
    got = []
    for ch in range(plan.n_chunks):
        for s in range(plan.chunk_ptr[ch], plan.chunk_ptr[ch + 1]):
            c0, start, end = _slot_range(plan, ch, s)
            got.extend((int(plan.chunk_comp[s]), c0 + i)
                       for i in range(start, end))
    return sorted(got)


def _lane_bins(start, end):
    """(32, L) bins of the backward's range [start, end) of a chunk in each
    lane's order, -1 past a lane's last (csrc/lorentzian.cu bwd_sums): the
    unaligned head a bin a lane, then float4 groups (lane l takes bins
    a_lo + 4 l + 128 j .. + 3), then the unaligned tail a bin a lane."""
    a_lo = min((start + 3) & ~3, end)
    a_hi = max(end & ~3, a_lo)
    lanes = [[] for _ in range(32)]
    for lane, bins in enumerate(lanes):
        if start + lane < a_lo:
            bins.append(start + lane)
        for i in range(a_lo + 4 * lane, a_hi, 128):
            bins.extend(range(i, i + 4))
        if a_hi + lane < end:
            bins.append(a_hi + lane)
    out = np.full((32, max(1, max(map(len, lanes)))), -1)
    for lane, bins in enumerate(lanes):
        out[lane, :len(bins)] = bins
    return out


def _fma(a, b, c):
    """fmaf in float32: the float64 product of two floats is exact and the
    sum is rounded once to float32 (twice where the float64 sum rounds
    first, far rarer than any difference these tests look for)."""
    return (np.float64(a) * b + np.float64(c)).astype(np.float32)


def _butterfly(acc):
    """The warp's xor butterfly over the last axis (32 lanes): lane 0's
    sum, which every lane holds."""
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = (acc + acc[..., lane ^ off]).astype(np.float32)
    return acc[..., 0]


def _bwd_record(s_nu, s_g, start, end, c, iw, wn, fast):
    """(Bt, 6) float32 record (Gk, Su, Sp, Sq, Sr, Ss) of one backward slot
    over bins [start, end) of a staged chunk, per walker with (Bt,)
    constants c, iw, wn (wn None: no window), in the kernel's lanes and
    order (csrc/lorentzian.cu bwd_bin, bwd_sums).  `fast` (Bt,) bool picks
    the arithmetic per walker: the loop without the clamp (w = x inv,
    p = g w; Su += fma(g, inv), Sp += p, Sq += fma(p, inv), Sr += fma(p, w);
    Ss = Sp - Sq after the butterfly) or the first version's (y clamped at
    2^125; u, p, q, r, s and their sums)."""
    idx = _lane_bins(start, end)
    bt = c.shape[0]
    sums = {}
    for path in {bool(f) for f in fast}:
        acc = np.zeros((6, bt, 32), np.float32)
        for j in range(idx.shape[1]):
            n = idx[:, j]
            live = (n >= 0)[None, :]
            nn = np.where(n >= 0, n, 0)
            with np.errstate(all="ignore"):
                d = (s_nu[nn][None, :] - c[:, None]).astype(np.float32)
                x = (d * iw[:, None]).astype(np.float32)
                gm = s_g[:, nn]
                if wn is not None:
                    gm = np.where(np.abs(d) <= wn[:, None], gm,
                                  np.float32(0))
                y = _fma(x, x, np.float32(1))
                if path:
                    inv = (np.float32(1) / y).astype(np.float32)
                    w = (x * inv).astype(np.float32)
                    p = (gm * w).astype(np.float32)
                    new = (acc[0] + gm, _fma(gm, inv, acc[1]), acc[2] + p,
                           _fma(p, inv, acc[3]), _fma(p, w, acc[4]), acc[5])
                else:
                    inv = (np.float32(1) / np.minimum(
                        y, np.float32(2.0 ** 125))).astype(np.float32)
                    u = (gm * inv).astype(np.float32)
                    p = (x * u).astype(np.float32)
                    q = (p * inv).astype(np.float32)
                    r = (x * q).astype(np.float32)
                    new = tuple(acc[m] + v for m, v in
                                enumerate((gm, u, p, q, r, x * r)))
            for m in range(6):
                acc[m] = np.where(live, np.asarray(new[m], np.float32),
                                  acc[m])
        rec = np.stack([_butterfly(a) for a in acc], -1)
        if path:
            rec[:, 5] = rec[:, 2] - rec[:, 3]
        sums[path] = rec
    if len(sums) == 1:
        return sums.popitem()[1]
    return np.where(np.asarray(fast)[:, None], sums[True], sums[False])


def _bwd_gsum(s_g, ln):
    """(Bt,) the sum of g over a staged chunk [0, ln) as the kernel forms it
    once for the slots that cover the chunk whole (csrc/lorentzian.cu
    bwd_gsum): a component's lanes, order and butterfly."""
    idx = _lane_bins(0, ln)
    acc = np.zeros((s_g.shape[0], 32), np.float32)
    for j in range(idx.shape[1]):
        n = idx[:, j]
        acc = np.where(n >= 0, acc + s_g[:, np.where(n >= 0, n, 0)], acc)
    return _butterfly(acc)


def _replay_backward(plan, nu, H, C, W, B, win, g, skip=None, parent=False):
    """numpy replay of the backward kernel over a plan: per chunk one record
    of six sums per slot over the slot's part of the staged chunk
    (`_bwd_record`, each (walker, component, chunk) on the path
    `lorentzian_kernel.unclamped` gives it, or all on the first version's
    with `parent`); in the segment and dense modes the sum of g of the
    slots that cover the chunk whole is the chunk's, formed once as a
    component's; per component the records added in chunk order, then the
    closed-form epilogue.  A windowed plan's skipped slot (`skip`, as in
    `_replay_kernels`) gets a zero record.  Returns (records (Bt, n_slots,
    6), [gH, gC, gW, gB])."""
    bt, nc = H.shape
    skip = plan.windowed if skip is None else skip
    if skip:
        chunk_vis = tk.window_visits(nu, C, win, plan.chunk, 1)
    fast = tk.unclamped(nu, C, W, plan.chunk) & (not parent)
    iw = tk.half_width_inverse(W)
    wn = win if plan.windowed else None
    scratch = np.full((bt, plan.n_slots, 6), np.nan, np.float32)
    for ch in range(plan.n_chunks):
        c0 = ch * plan.chunk
        ln = min(plan.chunk, plan.n_bins - c0)
        s_nu, s_g = nu[c0:c0 + ln], g[:, c0:c0 + ln]
        gsum = None
        if not plan.windowed and not parent \
                and plan.chunk_full[ch] > plan.chunk_ptr[ch]:
            gsum = _bwd_gsum(s_g, ln)
        for s in range(plan.chunk_ptr[ch], plan.chunk_ptr[ch + 1]):
            _, start, end = _slot_range(plan, ch, s)
            k = plan.chunk_comp[s]
            scratch[:, s] = _bwd_record(
                s_nu, s_g, start, end, C[:, k], iw[:, k],
                None if wn is None else wn[:, k], fast[:, k, ch])
            if gsum is not None and s < plan.chunk_full[ch]:
                scratch[:, s, 0] = gsum
            if skip:                      # the zero record of a skipped slot
                scratch[~chunk_vis[:, k, ch], s] = 0
    sums = np.zeros((nc, bt, 6), np.float32)
    for k in range(nc):
        for i in range(plan.comp_ptr[k], plan.comp_ptr[k + 1]):
            sums[k] += scratch[:, plan.comp_slot[i]]
    return scratch, _closed_form(sums.transpose(1, 0, 2), H, W, B, iw)


def _closed_form(sums, H, W, B, iw):
    """[gH, gC, gW, gB] from each (walker, component)'s six sums (Bt, NC, 6)
    in their dtype (csrc/lorentzian.cu bwd_finish)."""
    Gk, Su, Sp, Sq, Sr, Ss = np.moveaxis(sums, -1, 0)
    H, B = H.astype(sums.dtype), B.astype(sums.dtype)
    hb2 = 2 * H * B
    dx = hb2 * Su - 2 * H * Sq - 2 * hb2 * Sr
    dxx = hb2 * Sp - 2 * H * Sr - 2 * hb2 * Ss
    return [B * B * Gk + Su + 2 * B * Sp, -iw * dx,
            np.where(W > 1e-6, -dxx * iw * 0.5, 0).astype(sums.dtype),
            hb2 * Gk + 2 * H * Sp]


def _replay_kernels(plan, nu, H, C, W, B, win, g, skip=None, group=None):
    """numpy replay of csrc/lorentzian.cu over a plan.  Forward: per tile,
    the packed constants (c, iw, h, 2hb), (h b^2, win); components that
    cover the tile run unmasked and add h b^2 once, the rest masked per bin
    by range and window.  Backward: `_replay_backward`.

    A windowed plan skips as the kernels do (`skip`, its default; False
    replays the dense traversal): a tile's component only for the walkers
    of a `group` (FWD_W walkers a forward block, or 1 where the forward
    runs one a block) whose window meets it, a chunk's slot only for a
    walker whose window meets the chunk, a zero record for the others
    (lorentzian_kernel.window_visits)."""
    bt, nc = H.shape
    n_bins = nu.shape[0]
    skip = plan.windowed if skip is None else skip
    if group is None:
        group = tk.FWD_W if plan.wide_forward(bt) else 1
    if skip:
        walker_group = np.arange(bt) // group
        tile_vis = tk.window_visits(nu, C, win, plan.tile, group)
    iw = tk.half_width_inverse(W)
    pack_a = np.stack([C, iw, H, 2 * H * B], -1)             # (bt, nc, 4)
    pack_b = np.stack([H * B * B, win if plan.windowed
                       else np.zeros_like(H)], -1)           # (bt, nc, 2)
    out = np.zeros((bt, n_bins), np.float32)
    for t in range(plan.n_tiles):
        n = np.arange(t * plan.tile, min((t + 1) * plan.tile, n_bins))
        acc = np.zeros((bt, n.shape[0]), np.float32)
        cst = np.zeros((bt, 1), np.float32)
        p_full = plan.tile_ptr[t] if plan.windowed else plan.tile_full[t]
        for p in range(plan.tile_ptr[t], plan.tile_ptr[t + 1]):
            k = plan.tile_comp[p]
            c, iwk, h, hb2 = (pack_a[:, k, i:i + 1] for i in range(4))
            hbb, wn = (pack_b[:, k, i:i + 1] for i in range(2))
            d = nu[n][None, :] - c
            x = d * iwk
            t_inv = (h + hb2 * x) / (1 + x * x)
            if p < p_full:
                acc += t_inv
                cst += hbb
            else:
                keep = (n >= plan.comp_lo[k]) & (n < plan.comp_hi[k])
                if plan.windowed:
                    keep = keep & (np.abs(d) <= wn)
                v = np.where(keep, t_inv + hbb, 0)
                if skip:                  # the walkers whose block visits k
                    rows = tile_vis[walker_group, k, t]
                    acc[rows] += v[rows]
                else:
                    acc += v
        out[:, n] = acc + cst
    return out, _replay_backward(plan, nu, H, C, W, B, win, g, skip)[1]


# sizes: the kernels' own (one tile and one chunk at this grid) and small
# ones that give several tiles per range, chunks cut inside ranges and a
# ragged last chunk (700 = 7 * 96 + 28)
@pytest.mark.parametrize("sizes", [{}, {"tile": 64, "chunk": 96}],
                         ids=["kernel-sizes", "small-sizes"])
@pytest.mark.parametrize("mode", ["segment", "windowed", "dense"])
def test_kernel_replay_matches_plain(mode, sizes):
    """The kernels' algorithm over a plan equals the plain reference."""
    nu, args, segs, g = _segment_case(n=700, ncomp=20)
    H, C, W, B = args
    n, nc = nu.shape[0], H.shape[1]
    win = (6.0 * W if mode == "windowed"
           else np.full_like(W, np.inf)).astype(np.float32)
    if mode == "segment":
        plan = tk.segment_plan(segs, nc, n, **sizes)
    else:
        plan = tk.LorentzPlan(np.zeros(nc), np.full(nc, n), n,
                              windowed=mode == "windowed", **sizes)
    got = _replay_kernels(plan, nu, *args, win, g)
    tnu = torch.as_tensor(nu)
    if mode == "segment":
        want = _torch_val_grad(
            lambda *a: tl.sum_lorentzians_segments(tnu, *a, segs), args, g)
    else:
        want = _torch_val_grad(lambda *a: tl.sum_lorentzians_trunc(
            tnu, *a, torch.as_tensor(win)), args, g)
    _assert_pair(got, want)


@pytest.mark.parametrize("group", [1, tk.FWD_W])
def test_skipping_replay_is_bitwise_the_dense_one(group):
    """The windowed traversal that skips tiles and chunks gives the dense
    traversal's values and gradients bit for bit: a component it leaves out
    would have added 0 to every bin.  Small tiles and chunks so that most
    are skipped; a negative, a zero and an infinite window among them."""
    nu, args, _, g = _segment_case(n=700, ncomp=20)
    H, C, W, B = args
    n, nc = nu.shape[0], H.shape[1]
    win = (6.0 * W).astype(np.float32)
    win[0, :3], win[1, 3], win[2, 4] = -1.0, 0.0, np.inf
    plan = tk.LorentzPlan(np.zeros(nc), np.full(nc, n), n, windowed=True,
                          tile=64, chunk=96)
    vis = tk.window_visits(nu, C, win, plan.tile, group)
    assert 0.05 < vis.mean() < 0.6          # most tiles are skipped
    skipped = _replay_kernels(plan, nu, *args, win, g, group=group)
    dense = _replay_kernels(plan, nu, *args, win, g, skip=False)
    assert np.array_equal(skipped[0], dense[0])
    for a, b in zip(skipped[1], dense[1]):
        assert np.array_equal(a, b)


def _accuracy_case(case, g_kind, bt=16):
    """(plan, nu, (H, C, W, B), g) at a cell's widths, reduced in walkers
    and bins.  "kepler_full": 24 components over 12,000 bins of 11.33 nHz
    at 2,000 uHz, widths 0.5-3 uHz, on the segment plan of windows of 40
    widths + 10 uHz (ranges over several 4,096-bin chunks);
    "subgiant_mixed": 12 components over 7,576 bins of 7.92 nHz at 100 uHz,
    widths log-uniform from 1e-3 to 1 uHz, dense.  g: "normal", or "chi22p",
    dlogL/dM = (S / M - 1) / M of a spectrum S = M Exp(1) around a model M
    of these components over a background of 1."""
    rng = np.random.default_rng(22)
    if case == "kepler_full":
        n, nc, nu0, df = 12000, 24, 2000.0, 0.01133
        W = rng.uniform(0.5, 3.0, (bt, nc))
    else:
        n, nc, nu0, df = 7576, 12, 100.0, 0.00792
        W = np.exp(rng.uniform(np.log(1e-3), 0.0, (bt, nc)))
    nu = (nu0 + df * np.arange(n)).astype(np.float32)
    C = rng.uniform(nu0 + 10 * df, nu0 + (n - 10) * df, (bt, nc))
    C = np.sort(C, axis=1).astype(np.float32)
    H = rng.uniform(1, 50, (bt, nc)).astype(np.float32)
    B = rng.uniform(-0.1, 0.1, (bt, nc)).astype(np.float32)
    W = W.astype(np.float32)
    if case == "kepler_full":
        plan = tk.segment_plan(tl.partition_window_groups(
            tl.make_static_window_groups(C[0], 40 * W[0] + 10, nu0, df, n)),
            nc, n)
    else:
        plan = tk.dense_plan(n, nc)
    if g_kind == "normal":
        g = rng.normal(size=(bt, n))
    else:
        x = (nu[None, None, :] - C[..., None]) * (2 / W[..., None])
        M = 1 + np.sum(H[..., None] * (1 + 2 * B[..., None] * x)
                       / (1 + x * x) + H[..., None] * B[..., None] ** 2, 1)
        g = (rng.exponential(size=M.shape) - 1) / M
    return plan, nu, (H, C, W, B), g.astype(np.float32)


def _closed_form_f64(plan, nu, H, C, W, B, g):
    """The gradients in float64 at the kernels' float32 x and iw: each
    component's six sums over its range and the closed form."""
    iw = tk.half_width_inverse(W)
    sums = np.zeros(H.shape + (6,))
    for k in range(H.shape[1]):
        lo, hi = plan.comp_lo[k], plan.comp_hi[k]
        x = ((nu[None, lo:hi] - C[:, k:k + 1]).astype(np.float32)
             * iw[:, k:k + 1]).astype(np.float32).astype(np.float64)
        inv = 1 / (1 + x * x)
        gk = g[:, lo:hi].astype(np.float64)
        sums[:, k] = np.stack([(gk * t).sum(-1) for t in (
            1, inv, x * inv, x * inv ** 2, x * x * inv ** 2,
            x ** 3 * inv ** 2)], -1)
    return _closed_form(sums, H, W, B, iw.astype(np.float64))


@pytest.mark.parametrize("g_kind", ["normal", "chi22p"])
@pytest.mark.parametrize("case", ["kepler_full", "subgiant_mixed"])
def test_backward_loop_loses_no_accuracy(case, g_kind):
    """The float32 backward's loop without the clamp (Su and the products
    into Sq and Sr by FMA, Ss = Sp - Sq), replayed in the kernel's order, is
    as close to the float64 closed form as the first version's arithmetic:
    each gradient's relative error |got - want| / |want| (over all walkers
    and components) at most 1.5 times the first version's largest."""
    plan, nu, args, g = _accuracy_case(case, g_kind)
    H, C, W, B = args
    assert tk.unclamped(nu, C, W, plan.chunk).all()
    want = _closed_form_f64(plan, nu, *args, g)

    def errors(parent):
        got = _replay_backward(plan, nu, *args, None, g, parent=parent)[1]
        return [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                for a, b in zip(got, want)]
    new, first = errors(False), errors(True)
    assert max(new) <= 1.5 * max(first), (new, first)
    assert max(first) < 1e-6


# (walker, component, chunk) of a dense 3 x 12 x 700 plan in 96-bin chunks
# that must take the clamped loop, and the change to _segment_case's inputs
CLAMP_CASES = {
    "far centre": ({(1, 2, c) for c in range(8)},
                   lambda nu, C, W: C.__setitem__((1, 2), 1e20)),
    "nan centre": ({(0, 5, c) for c in range(8)},
                   lambda nu, C, W: C.__setitem__((0, 5), np.nan)),
    "inf centre": ({(2, 7, c) for c in range(8)},
                   lambda nu, C, W: C.__setitem__((2, 7), -np.inf)),
    "nan bin": ({(b, k, 1) for b in range(3) for k in range(12)},
                lambda nu, C, W: nu.__setitem__(150, np.nan)),
    # a width at the floor: |x| = |d| 2e6 passes 2^62 only past |d| of
    # 2.3e12 uHz
    "floor width, far centre": (
        {(1, 3, c) for c in range(8)},
        lambda nu, C, W: (W.__setitem__((1, 3), 1e-7),
                          C.__setitem__((1, 3), 2.5e12))),
    "floor width": (set(), lambda nu, C, W: W.__setitem__((0, 4), 1e-7)),
    "floor width, |x| just below 2^62": (
        set(), lambda nu, C, W: (W.__setitem__((2, 1), 1e-7),
                                 C.__setitem__((2, 1), -2.3e12))),
}


@pytest.mark.parametrize("case", list(CLAMP_CASES))
def test_clamp_rule(case):
    """lorentzian_kernel.unclamped, the backward's rule for its loop without
    the reciprocal's clamp: the ranges with |x| past 2^62, a NaN or
    infinite centre or a NaN bin take the clamped loop, whose replayed
    records are the first version's arithmetic bit for bit; every range
    the rule lets through has 1 + x^2 in [1, 2^125] at every bin, where
    the clamp changes nothing."""
    nu, args, _, g = _segment_case(n=700, ncomp=12)
    H, C, W, B = (a.copy() for a in args)
    want, change = CLAMP_CASES[case]
    change(nu, C, W)
    plan = tk.LorentzPlan(np.zeros(12), np.full(12, 700), 700, chunk=96)
    fast = tk.unclamped(nu, C, W, plan.chunk)
    assert set(zip(*np.nonzero(~fast))) == want
    recs = _replay_backward(plan, nu, H, C, W, B, None, g)[0]
    first = _replay_backward(plan, nu, H, C, W, B, None, g, parent=True)[0]
    iw = tk.half_width_inverse(W)
    for ch in range(plan.n_chunks):
        s_nu = nu[ch * 96:(ch + 1) * 96]
        for s in range(plan.chunk_ptr[ch], plan.chunk_ptr[ch + 1]):
            k = plan.chunk_comp[s]
            slow = ~fast[:, k, ch]
            assert np.array_equal(recs[slow, s], first[slow, s],
                                  equal_nan=True)
            x = ((s_nu[None, :] - C[fast[:, k, ch], k:k + 1])
                 .astype(np.float32) * iw[fast[:, k, ch], k:k + 1])
            y = _fma(x, x, np.float32(1))
            assert np.all((y >= 1) & (y <= 2.0 ** 125))


def _work_list_case(case):
    """(comp_lo, comp_hi, n_bins, chunk) of a backward work-list case."""
    if case == "range-longer-than-a-chunk":
        return [10, 300, 0], [650, 310, 1000], 1000, 128
    if case == "ragged-last-chunk":
        return [0, 0, 900], [1001, 1001, 1001], 1001, 256
    if case == "empty-ranges":
        return [5, 40, 0, 0], [5, 30, 0, 64], 64, 16
    if case == "segments":
        _, args, segs, _ = _segment_case(seed=3, n=2000, ncomp=40)
        plan = tk.segment_plan(segs, 40, 2000)
        return plan.comp_lo, plan.comp_hi, 2000, 192
    if case == "one-chunk":
        return [0, 7], [50, 33], 50, tk.BWD_CHUNK
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "range-longer-than-a-chunk", "ragged-last-chunk", "empty-ranges",
    "segments", "one-chunk"])
def test_backward_work_list(case):
    lo, hi, n_bins, chunk = _work_list_case(case)
    plan = tk.LorentzPlan(lo, hi, n_bins, chunk=chunk)
    want = sorted((k, n) for k in range(plan.ncomp)
                  for n in range(plan.comp_lo[k], plan.comp_hi[k]))
    got = _bwd_pairs(plan)
    # every (component, bin) pair of the ranges in exactly one slot
    assert got == want and len(set(got)) == len(got)
    # what a block stages fits a block's shared memory, and every staged
    # start (and every row of g, where n_bins allows) sits on 16 bytes
    assert plan.bwd_smem_bytes == 2 * 4 * chunk <= tk.SMEM_BUDGET
    assert all((ch * plan.chunk * 4) % 16 == 0 for ch in range(plan.n_chunks))
    assert plan.n_chunks == -(-n_bins // chunk)
    assert plan.n_slots == plan.chunk_ptr[-1] == len(plan.chunk_comp)
    for ch in range(plan.n_chunks):
        c0 = ch * chunk
        c1 = min(c0 + chunk, n_bins)
        p0, pf, p1 = (plan.chunk_ptr[ch], plan.chunk_full[ch],
                      plan.chunk_ptr[ch + 1])
        assert p0 <= pf <= p1
        for s in range(p0, p1):
            k = plan.chunk_comp[s]
            covers = plan.comp_lo[k] <= c0 and plan.comp_hi[k] >= c1
            assert covers == (s < pf)       # whole-chunk slots come first
            _, start, end = _slot_range(plan, ch, s)
            assert 0 <= start < end <= c1 - c0
    # a component's slots, in chunk order, are exactly its list
    chunk_of = np.repeat(np.arange(plan.n_chunks), np.diff(plan.chunk_ptr))
    for k in range(plan.ncomp):
        slots = plan.comp_slot[plan.comp_ptr[k]:plan.comp_ptr[k + 1]]
        assert np.all(plan.chunk_comp[slots] == k)
        assert np.all(np.diff(chunk_of[slots]) > 0)
        n_cover = 0 if plan.comp_hi[k] <= plan.comp_lo[k] else \
            (plan.comp_hi[k] - 1) // chunk - plan.comp_lo[k] // chunk + 1
        assert len(slots) == n_cover
    if case == "range-longer-than-a-chunk":
        assert plan.comp_ptr[1] - plan.comp_ptr[0] == 6      # 10..650 by 128
    if case == "ragged-last-chunk":
        assert n_bins % chunk and plan.chunk_full[-1] > plan.chunk_ptr[-2]
    if case == "empty-ranges":
        assert plan.comp_ptr[1] == plan.comp_ptr[3] == 0     # no slot at all


@pytest.mark.parametrize("chunk,ok", [(2048, True), (29056, True),
                                      (29060, False), (2050, False),
                                      (0, False)])
def test_backward_chunk_budget(chunk, ok):
    """A chunk is a multiple of 4 bins (16-byte staging) whose two staged
    arrays fit the 232,448 bytes of shared memory a block may use."""
    if ok:
        assert tk.LorentzPlan([0], [10], 10, chunk=chunk).bwd_smem_bytes \
            <= tk.SMEM_BUDGET
    else:
        with pytest.raises(ValueError, match="chunk"):
            tk.LorentzPlan([0], [10], 10, chunk=chunk)


# (n_bins, walkers) -> the backward's chunk and whether the forward runs
# four walkers a block: the slices' shapes keep the full sizes, a few
# walkers on a short grid get chunks halved down to the floor and one walker
# a block
@pytest.mark.parametrize("n_bins,bt,chunk,wide", [
    (40000, 768, 4096, True), (120000, 1280, 4096, True),
    (60000, 1024, 4096, True), (60000, 16, 512, False),
    (12288, 16, 512, False), (12288, 4096, 4096, True), (100, 1, 512, False)])
def test_plan_sizes_follow_the_grid(n_bins, bt, chunk, wide):
    plan = tk.dense_plan(n_bins, 5)
    small = plan.for_walkers(bt)
    assert small.chunk == chunk and plan.wide_forward(bt) == wide
    assert small is plan.for_walkers(bt)                     # cached
    assert (small is plan) == (chunk == tk.BWD_CHUNK)
    # the same ranges and forward lists, whatever the chunk
    assert np.array_equal(small.comp_hi, plan.comp_hi)
    assert np.array_equal(small.tile_comp, plan.tile_comp)
    assert small.windowed == plan.windowed and small.n_bins == n_bins
    assert _bwd_pairs(small) == _bwd_pairs(plan)


def test_kernel_takes_window_only_with_a_windowed_plan():
    assert tk.dense_plan(64, 3, windowed=True).windowed
    assert not tk.dense_plan(64, 3).windowed
    assert tk.dense_plan(64, 3) is tk.dense_plan(64, 3)      # cached


def test_kernel_path_refuses_cpu_tensors():
    """No silent fallback: the kernel entry raises on what it cannot run."""
    nu, args, _ = _mk()
    t = [torch.as_tensor(a) for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        tk.windowed_lorentzian_sum(torch.as_tensor(nu), *t,
                                   torch.full_like(t[0], np.inf),
                                   tk.dense_plan(nu.shape[0], 7))


@pytest.mark.parametrize("kind,windowed,bt,nc,n,comp_bins,want_ms,by", [
    # 9 x 1280 x 3,682,749 operations over 67e12/s
    ("fwd", False, 1280, 224, 120000, 3682749, 0.633213, "operations"),
    # 15 x 1024 x 210 x 60,000 over 67e12/s
    ("bwd", False, 1024, 210, 60000, 210 * 60000, 2.888597, "operations"),
    ("bwd", True, 16, 11, 12288, 11 * 12288, 0.00051645, "operations"),
    # one component: 4 (N + Bt N + 4 Bt) bytes over 3.35e12/s
    ("fwd", False, 8, 1, 1000, 1000, 1.0784e-5, "bytes")])
def test_bound_counts_what_the_function_needs(kind, windowed, bt, nc, n,
                                              comp_bins, want_ms, by):
    ms, bound_by = tk.bound_ms(kind, bt, nc, n, comp_bins, windowed)
    assert bound_by == by
    assert ms == pytest.approx(want_ms, rel=1e-4)


def test_forget_tickets_drops_the_counters():
    plan = tk.dense_plan(64, 3)
    plan._tickets["key"] = object()
    plan.forget_tickets()
    assert plan._tickets == {}


# ---------------------------------------------------------------------------
# the bf16 instantiation: its traversal of bin pairs, replayed
# ---------------------------------------------------------------------------

def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t):
    return t.float().numpy()


def _bwd_bf16_pairs(start, end, lanes=32):
    """The bin pairs (b0, b1) one warp of the bf16 backward forms over
    [start, end) of a staged chunk (lorentzian_kernel.bwd_bf16_steps, the
    traversal of csrc/lorentzian.cu bwd_range_bf16): a lane each for the up
    to three bins before the first 16-byte boundary and after the last,
    alone in a pair (b1 None: its partner lane has g = 0), and every float4
    group in between as two pairs."""
    pairs = []
    for step in tk.bwd_bf16_steps(start, end, lanes):
        for n0, n1, n2, n3 in step:
            if n0 is not None:
                pairs.append((n0, n1))
            if n2 is not None:
                pairs.append((n2, n3))
    return pairs


def _bf16_profile(x, h, hb2):
    """The plain version's bf16 stream for one component: float32 x in,
    (h + 2hb x) / (1 + x^2) out, each op rounded to bf16."""
    xb = _bf16(x)
    return _f32((_bf16(h) + _bf16(hb2) * xb) * (1.0 / (1.0 + xb * xb)))


def _replay_bf16_kernels(plan, nu, H, C, W, B, g):
    """numpy replay of the bf16 instantiation over a (segment or dense)
    plan, each bf16 op rounded as the plain version rounds it.  Forward:
    per tile the component pairs of lorentzian_kernel.fwd_bf16_pairs, the
    profile in bf16, each pair's two values added into the bin's float32
    sum (the tensor cores' diagonal sum), h b^2 float32 (once per walker
    for a pair of covering components, per bin in range for a masked one),
    the lone component of an odd chunk alone.  Backward: per slot
    the warp steps of bwd_bf16_steps, a lone bin's partner lane at g = 0,
    u, p, q, r, s of a step's lanes widened and summed in float32 before
    they join the slot's sums (the tensor cores' row sums); the sum of g
    and the closed form float32."""
    bt, nc = H.shape
    n_bins = nu.shape[0]
    iw = (2.0 / np.maximum(W, 1e-6)).astype(np.float32)
    hb2 = (2 * H * B).astype(np.float32)
    hbb = (H * B * B).astype(np.float32)
    out = np.zeros((bt, n_bins), np.float32)
    for t in range(plan.n_tiles):
        n = np.arange(t * plan.tile, min((t + 1) * plan.tile, n_bins))
        acc = np.zeros((bt, n.shape[0]), np.float32)
        cst = np.zeros((bt, 1), np.float32)
        for pair in tk.fwd_bf16_pairs(plan, t):
            k0, k1, masked = pair
            v = np.zeros((bt, n.shape[0]), np.float32)
            for k in (k0, k1):
                if k < 0:                   # no partner: a lone component
                    continue
                x = (nu[n][None, :] - C[:, k:k + 1]) * iw[:, k:k + 1]
                prof = _bf16_profile(x, H[:, k:k + 1], hb2[:, k:k + 1])
                if masked:
                    keep = (n >= plan.comp_lo[k]) & (n < plan.comp_hi[k])
                    acc += np.where(keep, hbb[:, k:k + 1], 0)
                    prof = np.where(keep, prof, 0)
                else:
                    cst += hbb[:, k:k + 1]
                v += prof
            acc += v
        out[:, n] = acc + cst
    sums = np.zeros((bt, nc, 6), np.float32)
    lone = 0
    for ch in range(plan.n_chunks):
        for s in range(plan.chunk_ptr[ch], plan.chunk_ptr[ch + 1]):
            c0, start, end = _slot_range(plan, ch, s)
            k = plan.chunk_comp[s]
            for step in tk.bwd_bf16_steps(start, end):
                bins = np.array([b for lane in step for b in lane
                                 if b is not None])
                if bins.size == 0:
                    continue
                lone += sum(lane[0] is not None and lane[1] is None
                            for lane in step)
                bins = c0 + bins
                gl = g[:, bins]
                xb = _bf16((nu[bins][None, :] - C[:, k:k + 1])
                           * iw[:, k:k + 1])
                inv = 1.0 / (1.0 + xb * xb)
                u = _bf16(gl) * inv
                p = xb * u
                q = p * inv
                r = xb * q
                sums[:, k] += np.stack(
                    [gl.sum(-1)] + [_f32(a).sum(-1)
                                    for a in (u, p, q, r, xb * r)], -1)
    Gk, Su, Sp, Sq, Sr, Ss = np.moveaxis(sums, -1, 0)
    dx = hb2 * Su - 2 * H * Sq - 2 * hb2 * Sr
    dxx = hb2 * Sp - 2 * H * Sr - 2 * hb2 * Ss
    grads = [B * B * Gk + Su + 2 * B * Sp, -iw * dx,
             np.where(W > 1e-6, -dxx * iw * 0.5, 0), hb2 * Gk + 2 * H * Sp]
    return (out, grads), lone


@pytest.mark.parametrize("sizes", [{}, {"tile": 64, "chunk": 96}],
                         ids=["kernel-sizes", "small-sizes"])
@pytest.mark.parametrize("mode", ["segment", "dense"])
def test_bf16_kernel_replay_matches_plain_bf16(mode, sizes):
    """The bf16 kernels' traversal (bin pairs, lone bins at a range's odd
    start or end) computes what the plain bf16 version does, to float32
    reassociation."""
    nu, args, segs, g = _segment_case(n=700, ncomp=20)
    H, C, W, B = args
    n, nc = nu.shape[0], H.shape[1]
    if mode == "segment":
        plan = tk.segment_plan(segs, nc, n, precision="bf16", **sizes)
    else:
        plan = tk.LorentzPlan(np.zeros(nc), np.full(nc, n), n,
                              precision="bf16", **sizes)
    ranges = [_slot_range(plan, ch, s)[1:] for ch in range(plan.n_chunks)
              for s in range(plan.chunk_ptr[ch], plan.chunk_ptr[ch + 1])]
    if mode == "segment":
        assert any(a % 2 for a, _ in ranges) and any(b % 2 for _, b in ranges)
    for start, end in ranges:           # each bin of a range exactly once
        flat = [b for pair in _bwd_bf16_pairs(start, end)
                for b in pair if b is not None]
        assert sorted(flat) == list(range(start, end))
    got, lone = _replay_bf16_kernels(plan, nu, *args, g)
    assert lone > 0 or mode == "dense"
    tnu = torch.as_tensor(nu)
    if mode == "segment":
        want = _torch_val_grad(lambda *a: tl.sum_lorentzians_segments(
            tnu, *a, segs, precision="bf16"), args, g)
    else:
        want = _torch_val_grad(lambda *a: tl.sum_lorentzians(
            tnu, *a, precision="bf16"), args, g)
    _assert_pair(got, want)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("bt,nc,n,comp_bins", [
    (768, 54, 40000, 536675), (1024, 210, 60000, 210 * 60000),
    (1280, 224, 120000, 3682749), (64, 36, 6000, 6000)])
def test_bf16_bound_is_no_longer_than_float32(kind, bt, nc, n, comp_bins):
    """The bf16 stream needs no more work than the float32 one: the same
    float32 d and x, packed bf16 arithmetic at twice the rate, and sums the
    tensor cores can take, so its bound never exceeds float32's."""
    ms16, _ = tk.bound_ms(kind, bt, nc, n, comp_bins, precision="bf16")
    ms32, _ = tk.bound_ms(kind, bt, nc, n, comp_bins)
    assert ms16 <= ms32


def test_bf16_plans_and_bounds():
    """bf16 is a plan property of the segment and dense modes only; its
    bound counts float32 operations at 67 TFLOP/s, packed bf16 ones at
    twice that and the float32 sums at the tensor cores' 989 TFLOP/s
    (lorentzian_kernel.FLOPS_BF16)."""
    plan = tk.dense_plan(64, 3, precision="bf16")
    assert plan.precision == "bf16" and not plan.windowed
    assert plan.for_walkers(1).precision == "bf16"
    assert plan is not tk.dense_plan(64, 3)
    with pytest.raises(ValueError, match="float32 only"):
        tk.dense_plan(64, 3, windowed=True, precision="bf16")
    with pytest.raises(ValueError, match="precision"):
        tk.LorentzPlan([0], [10], 10, precision="fp8")
    assert [tk.launch_key(k, p) for k in ("fwd", "bwd")
            for p in ("f32", "bf16")] == ["fwd", "fwd_bf16", "bwd",
                                          "bwd_bf16"]
    assert set(COUNTERS["launches"]) == {
        "fwd", "bwd", "fwd_bf16", "bwd_bf16", "fwd_chi22p",
        "fwd_chi22p_bf16", "fwd_f64", "bwd_f64", "fwd_chi22p_f64"}
    for kind, (n32, n16, ntc) in (("fwd", (4, 5, 2)), ("bwd", (4, 7, 10))):
        ms, by = tk.bound_ms(kind, 768, 54, 40000, 536675, precision="bf16")
        want = 1e3 * 768 * 536675 * (n32 / 67e12 + n16 / 134e12
                                     + ntc / 989e12)
        assert by == "operations" and ms == pytest.approx(want, rel=1e-12)
    with pytest.raises(ValueError, match="precision"):
        tl.segment_values(torch.zeros(8), *(torch.ones(1, 2),) * 4,
                          (((0, 1), 0, 8),), precision="fp8")
