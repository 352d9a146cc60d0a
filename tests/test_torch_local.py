"""The PyTorch port's MS_local family (models/local.py) against the JAX
reference, and the family's cross-parameter constraints.

The same float32 parameters, made from a seed with numpy, go through the
port as one batch of 3 walkers and through the reference as 3 single calls,
on a 600-bin window with n_per_l = (3, 2, 2, 1).  Tolerances (float32):
spectrum rtol 2e-5, atol 1e-6; the gradient of a weighted sum of the
spectrum within 1e-3 of its largest entry.  Widths are ~1 uHz (an ulp of a
centre moves a narrower profile by more than the tolerance) and the white
level is far above its 1e-9 floor, off the clamp's tie.

The reference's `_local_constraints` names a block `heights` that no
MS_local layout has and raises; the port bounds every `height_l*` and
`width_l*` block instead.  A test records the difference.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tamcmc_tpu.models import build_model as j_build_model
from tamcmc_tpu.stats.assemblers import \
    build_family_constraints as j_constraints
from tamcmc_tpu_torch.models import build_model
from tamcmc_tpu_torch.models.local import MSLocalHnlmSpec, MSLocalSpec
from tamcmc_tpu_torch.stats.assemblers import build_family_constraints
from tamcmc_tpu_torch.stats.priors import NEG_BIG

torch.set_num_threads(1)

N_PER_L = (3, 2, 2, 1)
NU = np.linspace(2080.0, 2360.0, 600).astype(np.float32)
SPECTRUM = dict(rtol=2e-5, atol=1e-6)
GRAD_REL = 1e-3
NAMES = ["model_MS_local_basic", "model_MS_local_Hnlm"]


def _params(layout, seed, walkers=3):
    rng = np.random.default_rng(seed)
    p, sd = np.zeros(layout.ndim), np.zeros(layout.ndim)
    base = {0: 2115.0, 1: 2157.5, 2: 2104.8, 3: 2138.8}
    for name in layout.names:
        o, s = layout.offset(name), layout.size(name)
        if name.startswith("height_l"):
            p[o:o + s], sd[o:o + s] = rng.uniform(2.0, 8.0, s), 0.2
        elif name.startswith("freq_l"):
            p[o:o + s] = base[int(name[-1])] + 85.0 * np.arange(s)
            sd[o:o + s] = 0.05
        elif name.startswith("width_l"):
            p[o:o + s], sd[o:o + s] = rng.uniform(0.8, 2.5, s), 0.02
        elif name.startswith("hfactor_l"):
            p[o:o + s], sd[o:o + s] = rng.uniform(0.2, 1.0, s), 0.02
        elif name == "rot":
            p[o:o + s], sd[o] = [1.2, 0.03], 0.05
        elif name == "noise":
            p[o], sd[o] = 0.6, 0.02
        elif name == "inclination":
            p[o], sd[o] = 0.9, 0.05
        else:
            raise AssertionError(name)
    return (p + sd * rng.standard_normal((walkers, layout.ndim))) \
        .astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_local_model_matches_reference(name):
    jfn, jlay = j_build_model(name, n_per_l=N_PER_L)
    tfn, tlay = build_model(name, n_per_l=N_PER_L)
    assert (tlay.names, tlay.sizes) == (jlay.names, jlay.sizes)
    params = _params(tlay, 1)
    g = np.random.default_rng(2).normal(size=(3, NU.shape[0])) \
        .astype(np.float32)
    jnu = jnp.asarray(NU)
    model = jax.jit(lambda p: jfn(p, jnu))
    grad = jax.jit(jax.grad(lambda p, gi: jnp.sum(gi * jfn(p, jnu))))
    want = np.stack([np.asarray(model(jnp.asarray(r))) for r in params])
    want_g = np.stack([np.asarray(grad(jnp.asarray(r), jnp.asarray(gi)))
                       for r, gi in zip(params, g)])
    leaf = torch.tensor(params, requires_grad=True)
    # `fixed` is what the Problem hands every model; the family ignores it
    out = tfn(leaf, torch.tensor(NU),
              fixed=(leaf[0].detach(), np.zeros(tlay.ndim, bool)))
    got_g, = torch.autograd.grad(out, leaf, torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), want, **SPECTRUM)
    scale = np.abs(want_g).max(axis=1, keepdims=True)
    assert np.all(np.abs(got_g.numpy() - want_g) <= GRAD_REL * scale)
    # every block of the layout carries a gradient
    for b in tlay.names:
        o, s = tlay.offset(b), tlay.size(b)
        assert s == 0 or np.any(got_g.numpy()[:, o:o + s] != 0), b


@pytest.mark.parametrize("name", NAMES)
def test_local_single_call_equals_its_batch_row(name):
    tfn, tlay = build_model(name, n_per_l=N_PER_L)
    params = torch.as_tensor(_params(tlay, 3))
    nu = torch.as_tensor(NU)
    both = tfn(params, nu)
    assert both.shape == (3, NU.shape[0])
    for i in range(3):
        np.testing.assert_allclose(tfn(params[i], nu).numpy(),
                                   both[i].numpy(), rtol=1e-6)
    H, C, W, B, noise = tfn._assemble(params)
    ncomp = sum(n * (2 * l + 1) for l, n in enumerate(N_PER_L))
    assert H.shape == C.shape == W.shape == B.shape == (3, ncomp)
    assert noise.shape == (3, 1)


def test_local_white_level_is_floored():
    tfn, tlay = build_model(NAMES[0], n_per_l=(1, 0, 0, 0))
    p = torch.as_tensor(_params(tlay, 4, walkers=1)[0])
    p[tlay.offset("height_l0")] = 0.0
    p[tlay.offset("noise")] = -3.0
    np.testing.assert_array_equal(tfn(p, torch.as_tensor(NU)).numpy(),
                                  np.float32(1e-9))


def test_hnlm_layout_has_factors_and_no_inclination():
    lay = MSLocalHnlmSpec(n_per_l=(2, 2, 0, 1)).layout()
    assert "inclination" not in lay.names
    assert [lay.size(f"hfactor_l{l}") for l in (1, 2, 3)] == [2, 0, 4]
    assert MSLocalSpec(n_per_l=(2, 2)).layout().size("freq_l3") == 0


@pytest.mark.parametrize("name", NAMES)
def test_local_constraints_bound_heights_widths_inclination(name):
    _, lay = build_model(name, n_per_l=N_PER_L)
    extra = build_family_constraints(name, lay)
    ok = torch.as_tensor(_params(lay, 5))
    np.testing.assert_array_equal(extra(ok).numpy(), 0.0)
    bad = ok.clone()
    bad[0, lay.offset("height_l2") + 1] = -0.1
    bad[1, lay.offset("width_l0")] = -1e-3
    bad[1, lay.offset("width_l3")] = -1e-3
    if "inclination" in lay.names:
        bad[2, lay.offset("inclination")] = 1.6
    want = [NEG_BIG, NEG_BIG, NEG_BIG if "inclination" in lay.names else 0.0]
    # two violations in one walker are floored at NEG_BIG, not summed
    np.testing.assert_allclose(extra(bad).numpy(), want, rtol=1e-6)
    # frequencies are free-ordered: windows do not overlap
    crossed = ok.clone()
    o = lay.offset("freq_l0")
    crossed[:, [o, o + 1]] = crossed[:, [o + 1, o]]
    np.testing.assert_array_equal(extra(crossed).numpy(), 0.0)
    # unbatched vectors too
    assert float(extra(bad[0])) == np.float32(NEG_BIG)


@pytest.mark.parametrize("name", NAMES)
def test_reference_local_constraints_raise_where_the_port_does_not(name):
    """The reference asks for a block named `heights`, which no MS_local
    layout has (they are `height_l0..3`): a known defect of the reference
    that the port does not copy."""
    _, jlay = j_build_model(name, n_per_l=N_PER_L)
    with pytest.raises(ValueError, match="not in tuple"):
        j_constraints(name, jlay)
    _, tlay = build_model(name, n_per_l=N_PER_L)
    assert callable(build_family_constraints(name, tlay))
