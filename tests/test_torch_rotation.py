"""The PyTorch port's rotation laws against the JAX reference: the
a-coefficient splitting, its centrifugal term, and the a1-eta-a3 splitting
with one a1 per order (the a1n / a1nl laws).

Inputs are made from a seed with numpy and fed to both packages.  The
reference is per-walker code under vmap; the port is batched over leading
dims, so each case runs single (no leading dim) and batched (4 walkers).
Tolerances (float32): values rtol 1e-6; gradients rtol 1e-5 of each
gradient's largest entry.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.ops import rotation as j_rot
from tamcmc_tpu_torch.ops import rotation as t_rot

torch.set_num_threads(1)

VAL = dict(rtol=1e-6, atol=0)
GRAD_REL = 1e-5


def _t(fn, args, g):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.as_tensor(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _j(fn, args, g, batched):
    ja = [jnp.asarray(a) for a in args]
    f = jax.vmap(fn) if batched else fn
    out = np.asarray(f(*ja))
    grads = jax.grad(lambda *a: jnp.sum(g * f(*a)),
                     argnums=tuple(range(len(args))))(*ja)
    return out, [np.asarray(x) for x in grads]


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], **VAL)
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        # an exactly zero gradient (a3 at l = 1, where P3 vanishes) is zero
        # in both
        assert np.abs(a - b).max() <= GRAD_REL * np.abs(b).max(), i


def _inputs(l, batched, seed):
    rng = np.random.default_rng(seed)
    lead = (4,) if batched else ()
    nu_nl = rng.uniform(2000, 3000, lead + (5,)).astype(np.float32)
    aj = (rng.uniform(-1, 1, lead + (6,))
          * [1.0, 0.1, 0.05, 0.02, 0.01, 0.005]).astype(np.float32)
    eta0 = rng.uniform(1e8, 3e8, lead).astype(np.float32)
    g = rng.normal(size=lead + (5, 2 * l + 1)).astype(np.float32)
    return nu_nl, aj, eta0, g


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_split_frequencies_aj(l, batched):
    nu_nl, aj, _, g = _inputs(l, batched, l)
    want = _j(lambda n, a: j_rot.split_frequencies_aj(l, n, a), [nu_nl, aj],
              g, batched)
    got = _t(lambda n, a: t_rot.split_frequencies_aj(l, n, a), [nu_nl, aj], g)
    assert got[0].shape == nu_nl.shape + (2 * l + 1,)
    if l == 0:
        # no polynomial row of degree 0: the centre alone, no gradient in aj
        np.testing.assert_array_equal(got[0][..., 0], nu_nl)
        np.testing.assert_allclose(got[0], want[0], **VAL)
        assert not np.any(got[1][1]) and not np.any(want[1][1])
        return
    _close(got, want)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_centrifugal_shift_aj(l, batched):
    nu_nl, aj, eta0, g = _inputs(l, batched, 10 + l)
    a1 = np.abs(aj[..., 0]) + np.float32(0.5)
    nlm = (nu_nl[..., None]
           + np.arange(-l, l + 1, dtype=np.float32) * a1[..., None, None])
    want = _j(lambda n, e, a: j_rot.centrifugal_shift_aj(l, n, e, a),
              [nlm, eta0, a1], g, batched)
    got = _t(lambda n, e, a: t_rot.centrifugal_shift_aj(l, n, e, a),
             [nlm, eta0, a1], g)
    _close(got, want)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_split_frequencies_a1etaa3_per_order_a1(l, batched):
    """a1 shaped like nu_nl, one splitting per radial order."""
    nu_nl, _, eta0, g = _inputs(l, batched, 20 + l)
    rng = np.random.default_rng(30 + l)
    a1 = rng.uniform(0.5, 2.0, nu_nl.shape).astype(np.float32)
    a3 = rng.uniform(-0.1, 0.1, eta0.shape).astype(np.float32)
    want = _j(lambda n, a, e, a3_: j_rot.split_frequencies_a1etaa3(
        l, n, a, e, a3_), [nu_nl, a1, eta0, a3], g, batched)
    got = _t(lambda n, a, e, a3_: t_rot.split_frequencies_a1etaa3(
        l, n, a, e, a3_), [nu_nl, a1, eta0, a3], g)
    _close(got, want)
    # each order's m = +-1 pair is split by twice its own a1, plus the a3
    # term, which is the same for every order (the eta term is even in m)
    rest = got[0][..., l + 1] - got[0][..., l - 1] - 2 * a1
    np.testing.assert_allclose(rest, rest[..., :1].repeat(5, -1), rtol=0,
                               atol=2e-3)
    assert np.abs(a1 - a1[..., :1]).max() > 0.1


def test_batched_aj_equals_stacked_single_calls():
    nu_nl, aj, eta0, _ = _inputs(2, True, 40)
    tn, ta, te = (torch.as_tensor(x) for x in (nu_nl, aj, eta0))
    both = t_rot.centrifugal_shift_aj(
        2, t_rot.split_frequencies_aj(2, tn, ta), te, ta[..., 0])
    for i in range(4):
        one = t_rot.centrifugal_shift_aj(
            2, t_rot.split_frequencies_aj(2, tn[i], ta[i]), te[i], ta[i, 0])
        assert torch.equal(both[i], one)
