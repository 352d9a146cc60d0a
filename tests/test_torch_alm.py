"""The PyTorch port's Alm activity perturbation (ops/alm.py) against the JAX
reference: the kernel shapes, each filter kind, A_lm and the shifts for
every (l, m), l <= 3.

Inputs are made from a seed with numpy and fed to both packages.
Tolerances (float32): values atol 2e-6 (A_lm lies in [0, 1]; the shifts are
held relative to epsilon nu_nl); gradients in (theta0, delta, epsilon)
rtol 1e-4 of each gradient's largest entry.  The inputs stay off the ties
where the two packages split a gradient differently: delta well above its
1e-3 floor, no triangle node exactly at the band's edge, bands too narrow to
overlap to exactly 1.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.ops import alm as j_alm
from tamcmc_tpu_torch.ops import alm as t_alm

torch.set_num_threads(1)

ATOL = 2e-6
GRAD_REL = 1e-4
KINDS = ["gate", "triangle", "gauss"]
LM = [(l, m) for l in range(4) for m in range(-l, l + 1)]


def _walkers(seed, n=5):
    rng = np.random.default_rng(seed)
    theta0 = rng.uniform(0.15, 1.2, n).astype(np.float32)
    delta = rng.uniform(0.08, 0.6, n).astype(np.float32)
    epsilon = rng.uniform(2e-4, 4e-3, n).astype(np.float32)
    return theta0, delta, epsilon


def _grad_close(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        scale = np.abs(b).max()
        assert scale > 0, i
        assert np.abs(np.asarray(a) - b).max() <= GRAD_REL * scale, i


@pytest.mark.parametrize("l,m", LM)
def test_plm2_matches_reference(l, m):
    x = np.cos(j_alm._THETA).astype(np.float32)
    want = np.asarray(j_alm._plm2(l, m, jnp.asarray(x)))
    got = t_alm._plm2(l, m, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the quadrature constants use the same function on numpy arrays
    np.testing.assert_allclose(t_alm._plm2(l, m, x), want, rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(NotImplementedError):
        t_alm._plm2(4, 0, torch.as_tensor(x))


@pytest.mark.parametrize("kind", KINDS)
def test_activity_filter_matches_reference(kind):
    theta0, delta, _ = _walkers(1)
    th = j_alm._THETA.astype(np.float32)
    g = np.random.default_rng(2).normal(size=(5, 96)).astype(np.float32)

    def jf(t0, d):
        return jax.vmap(lambda a, b: j_alm.activity_filter(
            jnp.asarray(th), a, b, kind=kind))(t0, d)

    want = np.asarray(jf(jnp.asarray(theta0), jnp.asarray(delta)))
    want_g = jax.grad(lambda a, b: jnp.sum(g * jf(a, b)), argnums=(0, 1))(
        jnp.asarray(theta0), jnp.asarray(delta))
    t0 = torch.tensor(theta0, requires_grad=True)
    d = torch.tensor(delta, requires_grad=True)
    out = t_alm.activity_filter(torch.as_tensor(th), t0, d, kind=kind)
    got_g = torch.autograd.grad(out, (t0, d), torch.as_tensor(g))
    assert out.shape == (5, 96)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL, rtol=0)
    assert 0.0 <= out.min() and out.max() <= 1.0
    _grad_close([x.numpy() for x in got_g], [np.asarray(x) for x in want_g])


def test_unknown_filter_kind_raises():
    theta0, delta, _ = (torch.as_tensor(a) for a in _walkers(1))
    with pytest.raises(KeyError, match="unknown activity filter"):
        t_alm.alm(1, 0, theta0, delta, kind="boxcar")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("l,m", LM)
def test_alm_matches_reference(l, m, kind):
    theta0, delta, _ = _walkers(3 + l)
    want = np.asarray(jax.vmap(lambda a, b: j_alm.alm(l, m, a, b, kind))(
        jnp.asarray(theta0), jnp.asarray(delta)))
    got = t_alm.alm(l, m, torch.as_tensor(theta0), torch.as_tensor(delta),
                    kind)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(want >= 0) and np.all(want <= 1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("l", [1, 2, 3])
def test_alm_shifts_match_reference(l, kind):
    theta0, delta, epsilon = _walkers(7 + l)
    rng = np.random.default_rng(11 + l)
    nu_nl = rng.uniform(2000, 3000, (5, 4)).astype(np.float32)
    g = rng.normal(size=(5, 4, 2 * l + 1)).astype(np.float32)

    def jf(n, e, t0, d):
        return jax.vmap(lambda *a: j_alm.alm_shifts(l, *a, kind=kind))(
            n, e, t0, d)

    args = (nu_nl, epsilon, theta0, delta)
    want = np.asarray(jf(*map(jnp.asarray, args)))
    want_g = jax.grad(lambda *a: jnp.sum(g * jf(*a)), argnums=(1, 2, 3))(
        *map(jnp.asarray, args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = t_alm.alm_shifts(l, *leaves, kind=kind)
    got_g = torch.autograd.grad(out, leaves[1:], torch.as_tensor(g))
    assert out.shape == (5, 4, 2 * l + 1)
    # a shift is epsilon nu_nl A_lm: hold it at A_lm's tolerance
    scale = (epsilon[:, None] * nu_nl)[..., None]
    np.testing.assert_allclose(out.detach().numpy() / scale, want / scale,
                               atol=ATOL, rtol=0)
    _grad_close([x.numpy() for x in got_g], [np.asarray(x) for x in want_g])
    # A_lm depends on |m| only
    np.testing.assert_array_equal(out.detach().numpy(),
                                  out.detach().numpy()[..., ::-1])


@pytest.mark.parametrize("kind", KINDS)
def test_batched_call_equals_stacked_single_calls_bitwise(kind):
    theta0, delta, epsilon = (torch.as_tensor(a) for a in _walkers(20))
    nu_nl = torch.as_tensor(np.random.default_rng(21).uniform(
        2000, 3000, (5, 4)).astype(np.float32))
    table = t_alm.alm_table(theta0, delta, kind)
    assert table.shape == (5, 10)
    for i in range(5):
        assert torch.equal(table[i], t_alm.alm_table(theta0[i], delta[i],
                                                     kind))
    for l in (1, 2, 3):
        both = t_alm.alm_shifts(l, nu_nl, epsilon, theta0, delta, kind)
        # the precomputed table gives the same shifts as the call's own
        assert torch.equal(both, t_alm.alm_shifts(
            l, nu_nl, epsilon, theta0, delta, kind, table=table))
        for i in range(5):
            assert torch.equal(both[i], t_alm.alm_shifts(
                l, nu_nl[i], epsilon[i], theta0[i], delta[i], kind))
        for m in range(-l, l + 1):
            assert torch.equal(t_alm.alm(l, m, theta0, delta, kind),
                               table[:, l * (l + 1) // 2 + abs(m)])


def test_quadrature_constants_are_cached_per_dtype_and_device():
    a = t_alm._quadrature(torch.float32, torch.device("cpu"))
    assert a is t_alm._quadrature(torch.float32, torch.device("cpu"))
    th, wk, den = a
    assert th.shape == (96,) and wk.shape == (10, 96) and den.shape == (10,)
    assert th.dtype == wk.dtype == den.dtype == torch.float32
    assert t_alm._quadrature(torch.float64,
                             torch.device("cpu"))[1].dtype == torch.float64


def test_the_gate_is_the_band_by_band_product():
    """The gate's one (..., n, 4) sigmoid of the four edges equals each
    hemisphere's band as the product of its two edge sigmoids, summed and
    capped at 1, in float64, values and gradients."""
    theta0, delta, _ = (torch.as_tensor(a, dtype=torch.float64)
                        for a in _walkers(30))
    th = torch.as_tensor(j_alm._THETA)
    g = torch.randn((5, 96), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(31))

    def by_band(t0, dl):
        lat = torch.pi / 2 - th
        d = torch.clamp(dl, min=1e-3)[:, None]

        def band(c):
            return (torch.sigmoid((lat - (c - d / 2)) / 0.02)
                    * torch.sigmoid(((c + d / 2) - lat) / 0.02))
        return torch.clamp(band(t0[:, None]) + band(-t0[:, None]), max=1.0)

    outs, grads = [], []
    for fn in (lambda a, b: t_alm.activity_filter(th, a, b), by_band):
        leaves = [theta0.clone().requires_grad_(), delta.clone()
                  .requires_grad_()]
        out = fn(*leaves)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, leaves, g))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-14)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_the_activity_block_takes_few_operations():
    """One table and the shifts of l = 1..3, forward and backward: at most
    80 dispatched operations that are not views, each a launch on the
    card.  With each band and edge as a tensor of its own, and each
    degree's rows flipped and concatenated, the block took 119, which
    left the ajAlm step's host further behind its device."""
    from torch.utils._python_dispatch import TorchDispatchMode
    theta0, delta, epsilon = (torch.as_tensor(a).requires_grad_()
                              for a in _walkers(40))
    gen = torch.Generator().manual_seed(41)
    nus = [(2000 + 1000 * torch.rand((5, 14), generator=gen))
           .requires_grad_() for _ in range(3)]
    ups = [torch.randn((5, 14, 2 * l + 1), generator=gen) for l in (1, 2, 3)]
    t_alm.alm_table(theta0, delta)              # the constants, uploaded
    [t_alm.alm_shifts(l, nus[l - 1], epsilon, theta0, delta)
     for l in (1, 2, 3)]
    ops = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                ops.append(func)
            return func(*args, **(kwargs or {}))

    with Ops():
        table = t_alm.alm_table(theta0, delta)
        outs = [t_alm.alm_shifts(l, nus[l - 1], epsilon, theta0, delta,
                                 table=table) for l in (1, 2, 3)]
        torch.autograd.grad(outs, [theta0, delta, epsilon, *nus], ups)
    assert len(ops) <= 80, len(ops)
