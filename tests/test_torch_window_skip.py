"""The windowed kernels' visit rule, against the function and the reference.

csrc/lorentzian.cu visits, in the windowed mode, a component in a forward
tile or a backward chunk only if its window meets the block's span of nu
(window_meets); `lorentzian_kernel.window_visits` states that rule in numpy
and the replay in tests/test_torch_lorentzian.py runs it.  Here:

(a) coverage, exhaustive: every (walker, component, bin) with
    |fl(nu - c)| <= win lies in a visited tile (1024 bins, FWD_W walkers a
    block and 1) and a visited chunk (4096 and 512 bins, one walker), on
    the reference Pallas test's shapes, kepler_full's grid with the demo's
    windows, a non-uniform grid, a descending one, a ragged last tile, and
    negative, zero, NaN and infinite windows;
(b) tightness: at the reference kernel's tiles (4096 bins) and programs (8
    walkers) on a uniform grid, the visited tiles lie inside the bounds
    [tlo, thi) of tamcmc_tpu/ops/pallas_lorentzian.py _prep, and those
    bounds hold every tile a bin needs;
(c) `in_window_bins`, the work the windowed bound counts, against a count
    bin by bin;
(d) NaN and infinite centres visit no tile, as in `_prep`, and the
    backward's shared memory mirrors the .cu's constants.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tamcmc_tpu.ops.pallas_lorentzian import LANE, SUBLANES, _prep
from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.kernel_ab import demo_windows, window_shares
from tamcmc_tpu_torch.ops import lorentzian_kernel as tk

torch.set_num_threads(1)

# (slab width, walkers a block): the forward's tiles, four walkers a block
# or one, and the backward's chunks at full size and at the smallest
BLOCKS = [(tk.FWD_TILE, tk.FWD_W), (tk.FWD_TILE, 1), (tk.BWD_CHUNK, 1),
          (tk.BWD_MIN_CHUNK, 1)]


def _pallas_case(seed=0):
    """tests/test_pallas.py TestPallasKernel's shapes: Bt 16, NC 11, N = 3 x
    4096 on [1000, 1400], win = 40 W."""
    rng = np.random.default_rng(seed)
    bt, nc, n = 16, 11, 3 * 4096
    nu = np.asarray(jnp.linspace(1000.0, 1400.0, n))
    H = rng.uniform(1, 5, (bt, nc)).astype(np.float32)
    C = rng.uniform(1050, 1350, (bt, nc)).astype(np.float32)
    W = rng.uniform(0.5, 3, (bt, nc)).astype(np.float32)
    B = rng.uniform(-0.1, 0.1, (bt, nc)).astype(np.float32)
    return nu, H, C, W, B, (40.0 * W).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _kepler_full_case(walkers=8):
    """kepler_full's 120,000-bin grid and `walkers` of the demo's walkers,
    each window trunc max(W, 1e-3) + 10 uHz from its own W."""
    problem = make_demo("kepler_full", seed=0, device="cpu")[0]
    H, C, W, B, win = (a.numpy() for a in demo_windows(
        problem, walkers, np.random.default_rng(0), "cpu"))
    return problem.nu.numpy(), H, C, W, B, win


def _spread_case(nu, seed=1, bt=10, nc=9):
    """Components spread over the grid's range with windows from a tenth
    of a bin to a fifth of the grid."""
    rng = np.random.default_rng(seed)
    lo, hi = float(np.nanmin(nu)), float(np.nanmax(nu))
    C = rng.uniform(lo - 5, hi + 5, (bt, nc)).astype(np.float32)
    win = np.exp(rng.uniform(np.log(0.01), np.log(0.2 * (hi - lo)),
                             (bt, nc))).astype(np.float32)
    return C, win


def _special_case():
    """A ragged grid (2,500 bins: tiles of 1024 end with 452) with NaN bins
    in one tile and one whole tile of NaN, and windows that are negative,
    -0, zero, NaN and +inf, centres that are NaN and infinite."""
    nu = np.linspace(100.0, 200.0, 2500).astype(np.float32)
    nu[1030:1034] = np.nan
    nu[512:1024] = np.nan                   # every bin of a 512-bin chunk
    C, win = _spread_case(nu, seed=2, bt=6, nc=12)
    win[0, :4] = [-1.0, -0.0, 0.0, np.nan]
    win[1, :2] = np.inf
    C[2, :3] = [np.nan, np.inf, -np.inf]
    C[3, :2] = [199.99, 100.01]             # the last and the first tile
    win[3, :2] = 0.02
    return nu, C, win


def _cases():
    nu, _, C, _, _, win = _pallas_case()
    yield "pallas-shapes", nu, C, win
    rng = np.random.default_rng(3)
    uneven = np.sort(rng.uniform(1000.0, 1400.0, 9000)).astype(np.float32)
    yield "non-uniform", uneven, *_spread_case(uneven)
    geometric = np.geomspace(50.0, 5000.0, 7000).astype(np.float32)
    yield "geometric", geometric, *_spread_case(geometric, seed=4)
    yield "descending", uneven[::-1].copy(), *_spread_case(uneven, seed=5)
    yield "special", *_special_case()


def _needed(nu, C, win, width):
    """(Bt, NC, n_slabs) bool: the slabs that hold a bin with
    |fl(nu - c)| <= win, walker by walker."""
    n = nu.shape[0]
    n_slabs = -(-n // width)
    out = np.zeros(C.shape + (n_slabs,), bool)
    for b in range(C.shape[0]):
        with np.errstate(invalid="ignore"):
            ok = np.abs(nu[None, :] - C[b][:, None]) <= win[b][:, None]
        pad = np.zeros((C.shape[1], n_slabs * width), bool)
        pad[:, :n] = ok
        out[b] = pad.reshape(C.shape[1], n_slabs, width).any(-1)
    return out


def _assert_covers(nu, C, win):
    for width, group in BLOCKS:
        need = _needed(nu, C, win, width)
        vis = tk.window_visits(nu, C, win, width, group)
        assert vis.shape == (-(-C.shape[0] // group),) + need.shape[1:]
        missed = need & ~vis[np.arange(C.shape[0]) // group]
        assert not missed.any(), (width, group, np.argwhere(missed)[:5])


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_every_bin_in_a_window_lies_in_a_visited_slab(case):
    _, nu, C, win = case
    _assert_covers(nu, C, win)


def test_kepler_full_windows_are_covered():
    nu, _, C, _, _, win = _kepler_full_case()
    _assert_covers(nu, C, win)
    # the tiles skip most of the grid, as the windows do
    vis = tk.window_visits(nu, C, win, tk.FWD_TILE, tk.FWD_W)
    assert 0.1 < vis.mean() < 0.2


def test_windows_that_pass_no_bin_visit_nothing():
    """A negative or NaN window and a NaN centre visit no slab; an infinite
    window with a finite centre visits every slab that holds a number; a
    window around the grid's first or last bin visits the first or the
    ragged last tile."""
    nu, C, win = _special_case()
    for width, _ in BLOCKS:
        vis = tk.window_visits(nu, C, win, width)
        assert not vis[0, [0, 3]].any() and not vis[2, 0].any()
        numbers = np.isfinite(tk.slab_spans(nu, width)[0])
        assert vis[1, 0][numbers].all() and vis[1, 1][numbers].all()
        assert vis[3, 0, -1] and vis[3, 1, 0]
    lo, hi = tk.slab_spans(nu, tk.BWD_MIN_CHUNK)
    assert lo[1] == np.inf and hi[1] == -np.inf     # a chunk of NaN bins
    assert lo[2] == nu[1024] and hi[2] == nu[1535]  # NaN bins passed over


@pytest.mark.parametrize("case", ["pallas-shapes", "kepler_full"])
def test_visits_lie_inside_the_reference_tile_bounds(case):
    """_prep's tile bounds are group-reduced over 8 walkers with a one-bin
    margin; the visit rule at the same tiles and groups is no looser, and
    the bounds hold every tile that a bin in a window needs (a tile they
    dropped would be a defect of the reference)."""
    nu, H, C, W, B, win = (_pallas_case() if case == "pallas-shapes"
                           else _kepler_full_case())
    out = _prep(nu, *(jnp.asarray(a) for a in (H, C, W, B, win)))
    tlo, thi = np.asarray(out[8]), np.asarray(out[9])     # (G, NC)
    vis = tk.window_visits(nu, C, win, LANE, SUBLANES)   # (G, NC, tiles)
    t = np.arange(vis.shape[-1])
    inside = (t >= tlo[..., None]) & (t < thi[..., None])
    assert not (vis & ~inside).any()
    need = _needed(nu, C, win, LANE)
    pad = np.zeros((-C.shape[0] % SUBLANES,) + need.shape[1:], bool)
    need = np.concatenate([need, pad]).reshape(vis.shape[0], SUBLANES,
                                               *need.shape[1:]).any(1)
    assert not (need & ~inside).any()
    assert vis.sum() <= inside.sum()


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_in_window_bins_counts_bin_by_bin(case):
    """The bisection's count on a non-decreasing grid; any other grid (a
    descending one, NaN bins) is refused."""
    _, nu, C, win = case
    if not np.all(nu[1:] >= nu[:-1]):
        with pytest.raises(ValueError, match="non-decreasing"):
            tk.in_window_bins(nu, C, win)
        return
    with np.errstate(invalid="ignore"):
        want = np.stack([(np.abs(nu[None, :] - c[:, None]) <= w[:, None])
                         .sum(-1) for c, w in zip(C, win)])
    assert np.array_equal(tk.in_window_bins(nu, C, win), want)


def test_centres_off_the_line_visit_no_tile_as_in_the_reference():
    """A NaN or infinite centre: the kernels visit no tile for it (their
    gradient record is 0; the plain version's is NaN, 0 x NaN in a masked
    bin), and _prep's tile bounds [tlo, thi) are empty for it too."""
    nu, H, C, W, B, win = _pallas_case()
    C = C[:SUBLANES].copy()
    C[0, :3] = [np.nan, np.inf, -np.inf]
    H, W, B, win = (a[:SUBLANES] for a in (H, W, B, win))
    for width, group in BLOCKS + [(LANE, SUBLANES)]:
        vis = tk.window_visits(nu, C[:1], win[:1], width, group)
        assert not vis[0, :3].any() and vis[0, 3:].any(axis=-1).all()
    out = _prep(nu, *(jnp.asarray(a) for a in (H, C, W, B, win)))
    # the same components given a negative window, which _prep defines as
    # visiting no tile, give the same group bounds
    none = win.copy()
    none[0, :3] = -1.0
    ref = _prep(nu, *(jnp.asarray(a) for a in (H, C, W, B, none)))
    assert np.array_equal(np.asarray(out[8]), np.asarray(ref[8]))
    assert np.array_equal(np.asarray(out[9]), np.asarray(ref[9]))


def test_backward_window_smem_matches_the_cuda_source():
    """BWD_WIN_SMEM follows from the mirrors of the .cu's BWD_THREADS and
    BWD_ROUND, which must equal the source's #defines."""
    cu = (Path(tk.__file__).parent.parent / "csrc"
          / "lorentzian.cu").read_text()
    threads = int(re.search(r"#define BWD_THREADS (\d+)", cu)[1])
    per = int(re.search(r"#define BWD_ROUND \((\d+) \* BWD_THREADS\)",
                        cu)[1])
    assert (threads, per * threads) == (tk.BWD_THREADS, tk.BWD_ROUND)
    assert "__shared__ int s_slot[BWD_ROUND], s_comp[BWD_ROUND];" in cu
    assert "__shared__ int s_cnt[Q][NW];" in cu
    assert "__shared__ float2 s_span[NT / 32];" in cu
    assert tk.BWD_WIN_SMEM == 4192


def test_window_shares_of_a_regime():
    """kernel_ab's shares of the (walker, component, bin) triples: the
    visited ones hold the in-window ones, and the in-window count is the
    bound's work."""
    nu, _, C, _, _, win = _kepler_full_case()
    s = window_shares(nu, C, win)
    bt, nc = C.shape
    assert s["in_window_comp_bins_per_walker"] == pytest.approx(
        tk.in_window_bins(nu, C, win).sum() / bt)
    assert s["in_window_share"] == pytest.approx(
        s["in_window_comp_bins_per_walker"] / (nc * nu.shape[0]))
    assert s["in_window_share"] <= s["visited_share_fwd"] < 0.2
    assert s["in_window_share"] <= s["visited_share_bwd"] < 0.2
