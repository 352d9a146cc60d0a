"""The PyTorch port's Lorentzian ops against the JAX reference.

Every input is made once with numpy from a seed and fed to both packages.
On the CPU the port runs its plain torch versions; the JAX windowed entry
`sum_lorentzians_trunc_batched` falls back to `sum_lorentzians_trunc` there.
The CUDA kernels themselves are checked on the card by chip_smoke.py; here
their host-side plan (ranges, tiles, CSR) is checked by replaying the
kernels' traversal in numpy.

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
    plan = tk.segment_plan(segs, ncomp, 1000)
    want = sorted((k, n) for idx, lo, hi in segs for k in idx
                  for n in range(lo, hi))
    got = []
    for t in range(plan.n_tiles):           # the forward kernel's traversal
        for k in plan.tile_comp[plan.tile_ptr[t]:plan.tile_ptr[t + 1]]:
            for n in range(t * tk.TILE, min((t + 1) * tk.TILE, 1000)):
                if plan.comp_lo[k] <= n < plan.comp_hi[k]:
                    got.append((int(k), n))
    assert sorted(got) == want and len(set(got)) == len(got)
    # the backward kernel's traversal: each component over its range
    bwd = sorted((k, n) for k in range(ncomp)
                 for n in range(plan.comp_lo[k], plan.comp_hi[k]))
    assert bwd == want
    assert plan.comp_bins() == len(want)


def test_segment_plan_rejects_non_adjacent_segments():
    segs = (((0, 1), 0, 10), ((1,), 10, 20), ((0,), 30, 40))
    with pytest.raises(ValueError, match="non-adjacent"):
        tk.segment_plan(segs, 2, 50)


def _replay_kernels(plan, nu, H, C, W, B, win, g):
    """numpy replay of csrc/lorentzian.cu: forward per tile over its CSR
    list with the per-bin range and window masks; backward per component
    over its range with the closed-form epilogue."""
    bt, nc = H.shape
    out = np.zeros((bt, nu.shape[0]), np.float32)
    for t in range(plan.n_tiles):
        n = np.arange(t * tk.TILE, min((t + 1) * tk.TILE, nu.shape[0]))
        for k in plan.tile_comp[plan.tile_ptr[t]:plan.tile_ptr[t + 1]]:
            m = (n >= plan.comp_lo[k]) & (n < plan.comp_hi[k])
            d = nu[n][None, :] - C[:, k:k + 1]
            x = d * (2.0 / np.maximum(W[:, k:k + 1], 1e-6))
            v = H[:, k:k + 1] * B[:, k:k + 1] ** 2 \
                + (H[:, k:k + 1] + 2 * H[:, k:k + 1] * B[:, k:k + 1] * x) \
                / (1 + x * x)
            out[:, n] += np.where(m & (np.abs(d) <= win[:, k:k + 1]), v, 0)
    grads = np.zeros((4, bt, nc), np.float32)
    for k in range(nc):
        n = np.arange(plan.comp_lo[k], plan.comp_hi[k])
        h, b = H[:, k:k + 1], B[:, k:k + 1]
        iw = 2.0 / np.maximum(W[:, k:k + 1], 1e-6)
        d = nu[n][None, :] - C[:, k:k + 1]
        x = d * iw
        inv = 1 / (1 + x * x)
        gm = np.where(np.abs(d) <= win[:, k:k + 1], g[:, n], 0)
        u = gm * inv
        p = x * u
        q = p * inv
        r = x * q
        s = x * r
        Gk, Su, Sp, Sq, Sr, Ss = (a.sum(-1, keepdims=True)
                                  for a in (gm, u, p, q, r, s))
        hb2 = 2 * h * b
        dx = hb2 * Su - 2 * h * Sq - 2 * hb2 * Sr
        dxx = hb2 * Sp - 2 * h * Sr - 2 * hb2 * Ss
        grads[0, :, k] = (b * b * Gk + Su + 2 * b * Sp)[:, 0]
        grads[1, :, k] = (-iw * dx)[:, 0]
        grads[2, :, k] = np.where(W[:, k:k + 1] > 1e-6,
                                  -dxx * iw * 0.5, 0)[:, 0]
        grads[3, :, k] = (hb2 * Gk + 2 * h * Sp)[:, 0]
    return out, list(grads)


@pytest.mark.parametrize("mode", ["segment", "windowed", "dense"])
def test_kernel_replay_matches_plain(mode):
    """The kernels' algorithm over a plan equals the plain reference."""
    nu, args, segs, g = _segment_case(n=700, ncomp=20)
    H, C, W, B = args
    n, nc = nu.shape[0], H.shape[1]
    win = (6.0 * W if mode == "windowed"
           else np.full_like(W, np.inf)).astype(np.float32)
    plan = tk.segment_plan(segs, nc, n) if mode == "segment" \
        else tk.dense_plan(n, nc)
    got = _replay_kernels(plan, nu, *args, win, g)
    tnu = torch.as_tensor(nu)
    if mode == "segment":
        want = _torch_val_grad(
            lambda *a: tl.sum_lorentzians_segments(tnu, *a, segs), args, g)
    else:
        want = _torch_val_grad(lambda *a: tl.sum_lorentzians_trunc(
            tnu, *a, torch.as_tensor(win)), args, g)
    _assert_pair(got, want)


def test_kernel_path_refuses_cpu_tensors():
    """No silent fallback: the kernel entry raises on what it cannot run."""
    nu, args, _ = _mk()
    t = [torch.as_tensor(a) for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        tk.windowed_lorentzian_sum(torch.as_tensor(nu), *t,
                                   torch.full_like(t[0], np.inf),
                                   tk.dense_plan(nu.shape[0], 7))
