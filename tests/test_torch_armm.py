"""The PyTorch port's mixed-mode solver and the small ops of the model
breadth (width relation, Kallinger background, single Lorentzian profile)
against the JAX reference.

The port's solver is batched over walkers; the reference is one star, so it
is vmapped.  Inputs are made with numpy from a seed, around the
subgiant_mixed demo's truth (Dnu 10 uHz, eps_p 0.4, DPi1 80 s, eps_g 0,
q 0.15 on [100, 160] uHz), with and without the O(2) terms of
tests/test_armm.py::TestSecondOrderAsymptotics.  Tolerances: the validity
mask exactly; frequencies atol 1e-4 uHz; zeta atol 1e-5; gradients rtol
3e-3, atol 3e-4 of the gradient scale; other values rtol 2e-5, atol 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.ops import armm as ja
from tamcmc_tpu.ops.lorentzian import lorentzian_profile as j_profile
from tamcmc_tpu.ops.noise import kallinger2014 as j_kallinger
from tamcmc_tpu.ops.widths import appourchaux2016_width as j_width
from tamcmc_tpu_torch.ops import armm as ta
from tamcmc_tpu_torch.ops.lorentzian import lorentzian_profile as t_profile
from tamcmc_tpu_torch.ops.noise import kallinger2014 as t_kallinger
from tamcmc_tpu_torch.ops.widths import appourchaux2016_width as t_width

torch.set_num_threads(1)

VAL = dict(rtol=2e-5, atol=1e-5)
GRAD = dict(rtol=3e-3, atol=3e-4)
NUMIN, NUMAX = 100.0, 160.0
NP, NG = ja.count_poles(10.0, 80.0, 0.4, 0.0, NUMIN, NUMAX)


def _grad_close(got, want, name):
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, err_msg=name,
                               **GRAD)


def _inputs(seed, o2):
    """(8, B) float32: dnu, eps_p, dpi1, eps_g, q, delta0l, alpha_p,
    alpha_g for B = 6 walkers around the demo truth."""
    rng = np.random.default_rng(seed)
    b = 6
    x = np.stack([
        10.0 + 0.05 * rng.standard_normal(b),
        0.4 + 0.02 * rng.standard_normal(b),
        80.0 + 0.5 * rng.standard_normal(b),
        0.0 + 0.02 * rng.standard_normal(b),
        0.15 + 0.01 * rng.standard_normal(b),
        np.full(b, o2[0]) + (0.05 * rng.standard_normal(b) if o2[0] else 0),
        np.full(b, o2[1]), np.full(b, o2[2])])
    return x.astype(np.float32)


# (delta0l, alpha_p, alpha_g): first order, then each O(2) term, then all
O2_CASES = [(0.0, 0.0, 0.0), (0.8, 0.0, 0.0), (0.0, 0.02, 0.0),
            (0.0, 0.0, 2e-3), (0.1, 0.01, 1e-3)]


def _j_solver(*a):
    return jax.vmap(lambda *r: ja.mixed_mode_frequencies(
        r[0], r[1], r[2], r[3], r[4], NUMIN, NUMAX, NP, NG,
        delta0l=r[5], alpha_p=r[6], alpha_g=r[7]))(*a)


def _t_solver(*a):
    return ta.mixed_mode_frequencies(
        a[0], a[1], a[2], a[3], a[4], NUMIN, NUMAX, NP, NG,
        delta0l=a[5], alpha_p=a[6], alpha_g=a[7])


@pytest.mark.parametrize("o2", O2_CASES)
def test_mixed_mode_frequencies_matches_jax(o2):
    x = _inputs(0, o2)
    jf, jz, jv = (np.asarray(t) for t in jax.jit(_j_solver)(*x))
    with torch.no_grad():
        tf, tz, tv = (t.numpy() for t in _t_solver(*map(torch.as_tensor, x)))
    assert tf.shape == jf.shape == (6, NP + NG - 1)
    np.testing.assert_array_equal(tv, jv)
    assert 40 < jv.sum(-1).min()            # a real forest in every walker
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tz, jz, rtol=0, atol=1e-5)


@pytest.mark.parametrize("o2", [O2_CASES[0], O2_CASES[-1]])
def test_mixed_mode_gradients_match_jax(o2):
    """Gradients of sum(a freqs + b zeta) with respect to all eight inputs;
    they flow through the bracket ends and the closed forms, never the
    bisection's decisions, in both packages."""
    x = _inputs(1, o2)
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, NP + NG - 1)).astype(np.float32)
    b = rng.normal(size=(6, NP + NG - 1)).astype(np.float32)

    def j_loss(*xs):
        f, z, _ = _j_solver(*xs)
        return jnp.sum(a * f + b * z)

    want = jax.jit(jax.grad(j_loss, argnums=tuple(range(8))))(*x)
    leaves = [torch.tensor(v, requires_grad=True) for v in x]
    f, z, _ = _t_solver(*leaves)
    got = torch.autograd.grad((torch.as_tensor(a) * f
                               + torch.as_tensor(b) * z).sum(), leaves,
                              allow_unused=True)
    names = ["dnu", "eps_p", "dpi1", "eps_g", "q", "delta0l", "alpha_p",
             "alpha_g"]
    for g, w, name in zip(got, want, names):
        g = np.zeros(6, np.float32) if g is None else g.numpy()
        _grad_close(g, np.asarray(w), name)


@pytest.mark.parametrize("args", [(10.0, 80.0, 0.4, 0.0, 100.0, 160.0),
                                  (10.0, 40.0, 0.4, 0.0, 100.0, 160.0),
                                  (85.0, 300.0, 0.3, 0.1, 1800.0, 2600.0, 2)])
def test_count_poles_equal(args):
    assert ta.count_poles(*args) == ja.count_poles(*args)


def test_appourchaux2016_width_matches_jax():
    rng = np.random.default_rng(3)
    nu = rng.uniform(1500, 3000, (4, 9)).astype(np.float32)
    pars = np.stack([rng.uniform(2000, 2500, 4), rng.uniform(3, 6, 4),
                     rng.uniform(0.5, 2, 4), rng.uniform(1.5, 4, 4),
                     rng.uniform(2000, 2500, 4), rng.uniform(2800, 3500, 4)]
                    ).astype(np.float32)
    g = rng.normal(size=nu.shape).astype(np.float32)

    def j_fn(n, *p):
        return jax.vmap(j_width)(n, *p)

    jargs = [jnp.asarray(nu)] + [jnp.asarray(p) for p in pars]
    want = np.asarray(j_fn(*jargs))
    want_g = jax.grad(lambda *a: jnp.sum(g * j_fn(*a)),
                      argnums=tuple(range(7)))(*jargs)
    leaves = [torch.tensor(nu, requires_grad=True)] + [
        torch.tensor(p, requires_grad=True) for p in pars]
    out = t_width(leaves[0], *(p[:, None] for p in leaves[1:]))
    got_g = torch.autograd.grad(out, leaves, torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), want, **VAL)
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        _grad_close(a.numpy(), np.asarray(b), f"arg {i}")


def test_kallinger2014_matches_jax():
    rng = np.random.default_rng(4)
    nu = np.linspace(0.0, 280.0, 257).astype(np.float32)   # sinc(0) included
    noise = np.stack([rng.uniform(30, 80, 3), rng.uniform(20, 60, 3),
                      rng.uniform(30, 80, 3), rng.uniform(80, 150, 3),
                      rng.uniform(0.5, 2, 3)], -1).astype(np.float32)
    noise[2, 2] = -1.0                       # an absent component
    g = rng.normal(size=(3, 257)).astype(np.float32)
    jfn = jax.vmap(lambda r: j_kallinger(jnp.asarray(nu), r, 283.2))
    want = np.asarray(jfn(jnp.asarray(noise)))
    want_g = np.asarray(jax.grad(lambda n: jnp.sum(g * jfn(n)))(
        jnp.asarray(noise)))
    leaf = torch.tensor(noise, requires_grad=True)
    out = t_kallinger(torch.as_tensor(nu), leaf, 283.2)
    got_g, = torch.autograd.grad(out, leaf, torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), want, **VAL)
    _grad_close(got_g.numpy(), want_g, "noise")


def test_lorentzian_profile_matches_jax():
    rng = np.random.default_rng(5)
    nu = np.linspace(40.0, 60.0, 301).astype(np.float32)
    p = np.stack([rng.uniform(1, 10, 4), rng.uniform(45, 55, 4),
                  rng.uniform(0.5, 3, 4), rng.uniform(-0.1, 0.1, 4)]
                 ).astype(np.float32)
    g = rng.normal(size=(4, 301)).astype(np.float32)
    jfn = jax.vmap(lambda *r: j_profile(jnp.asarray(nu), *r))
    jargs = [jnp.asarray(a) for a in p]
    want = np.asarray(jfn(*jargs))
    want_g = jax.grad(lambda *a: jnp.sum(g * jfn(*a)), argnums=(0, 1, 2, 3))(
        *jargs)
    leaves = [torch.tensor(a, requires_grad=True) for a in p]
    out = t_profile(torch.as_tensor(nu), *(a[:, None] for a in leaves))
    got_g = torch.autograd.grad(out, leaves, torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), want, **VAL)
    for a, b, name in zip(got_g, want_g, "HCWB"):
        _grad_close(a.numpy(), np.asarray(b), name)
