"""The ARMM solver's bisection kernel pair (ops/armm_kernel.py,
csrc/armm.cu) against its plain loop (ops/armm.py `bisect_plain`).

CPU: CPU tensors take the plain loop and launch nothing; the backward
kernel's recurrence, replayed as torch ops (`armm_kernel.replay_backward`),
is autograd's gradient of the plain loop bit for bit.  The card (`-m card`,
skipped without CUDA): at the dense cell's shape (64,512 walkers x 60
slots) around its truth, with a NaN walker, a walker whose q is NaN and a
walker whose intervals collapse, in float32 and float64 and for each O(2)
case, the kernels' roots, zeta, validity and the gradients to all eight
inputs are the plain loop's on the card bit for bit, the forward's mask is
the plain loop's decisions, and the backward kernel is the replay on
gradients with zeros of both signs, subnormals, infinities and NaN.  No
JAX: the card's machine runs this file with `python -m pytest --noconftest
tests/test_torch_armm_kernel.py -m card`.
"""

import numpy as np
import pytest
import torch

from tamcmc_tpu_torch.ops import armm as ta
from tamcmc_tpu_torch.ops import armm_kernel as ak
from tamcmc_tpu_torch.utils.metrics import COUNTERS, counters, counters_since

NUMIN, NUMAX = 100.0, 160.0
NP, NG = ta.count_poles(10.0, 80.0, 0.4, 0.0, NUMIN, NUMAX)
CELL_WALKERS = 63 * 8 * 128          # subgiant_mixed.stack63
N_BISECT = 45
NAMES = ("dnu", "eps_p", "dpi1", "eps_g", "q", "delta0l", "alpha_p",
         "alpha_g")
# (delta0l, alpha_p, alpha_g): first order, then each O(2) term, then all
# (tests/test_torch_armm.py)
O2_CASES = [(0.0, 0.0, 0.0), (0.8, 0.0, 0.0), (0.0, 0.02, 0.0),
            (0.0, 0.0, 2e-3), (0.1, 0.01, 1e-3)]
DTYPES = [torch.float32, torch.float64]


def _inputs(n, o2, seed, dtype, device):
    """The solver's eight inputs for n walkers around the subgiant_mixed
    truth (Dnu 10, eps_p 0.4, DPi1 80 s, eps_g 0, q 0.15); walker 0 has a
    NaN Dnu, walker 1 a NaN q, and walker 2 (Dnu 100, DPi1 1,000 s) has
    most of its poles clamped onto the window's edges, so most of its
    intervals collapse (lo > hi after the eps shift)."""
    rng = np.random.default_rng(seed)
    x = np.stack([
        10.0 + 0.3 * rng.standard_normal(n),
        0.4 + 0.05 * rng.standard_normal(n),
        80.0 + 3.0 * rng.standard_normal(n),
        0.1 * rng.standard_normal(n),
        0.15 + 0.03 * rng.standard_normal(n),
        np.full(n, o2[0]) + (0.05 * rng.standard_normal(n) if o2[0]
                             else 0.0),
        np.full(n, o2[1]), np.full(n, o2[2])])
    x[0, 0] = np.nan
    x[4, 1] = np.nan
    x[:, 2] = (100.0, 0.4, 1000.0, 0.0, 0.15, 0.0, 0.0, 0.0)
    return [torch.tensor(v, dtype=dtype, device=device) for v in x]


def _solve(xs):
    return ta.mixed_mode_frequencies(
        *xs[:5], NUMIN, NUMAX, NP, NG, N_BISECT, delta0l=xs[5],
        alpha_p=xs[6], alpha_g=xs[7])


def _special(shape, dtype, device, seed):
    """An upstream gradient of ordinary values with zeros of both signs,
    subnormals, infinities and NaN mixed in."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape)
    tiny = np.finfo(np.float32 if dtype == torch.float32
                    else np.float64).smallest_subnormal
    picks = [0.0, -0.0, tiny, -3 * tiny, np.inf, -np.inf, np.nan]
    where = rng.integers(0, 4 * len(picks), size=shape)
    for i, v in enumerate(picks):
        g[where == i] = v
    return torch.tensor(g, dtype=dtype, device=device)


def _same_bits(got, want, what):
    """Equal bit for bit, NaN against NaN in the same places."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), f"{what}: NaN places differ"
    itype = torch.int64 if got.dtype == torch.float64 else torch.int32
    g = torch.where(nan, torch.zeros_like(got), got).view(itype)
    w = torch.where(nan, torch.zeros_like(want), want).view(itype)
    bad = int((g != w).sum())
    assert bad == 0, f"{what}: {bad} of {g.numel()} values differ"


def _captured_brackets(xs, monkeypatch):
    """The brackets and walker scalars `mixed_mode_frequencies` hands its
    bisection for inputs xs."""
    seen = []

    def capture(lo, hi, n_bisect, *walker):
        seen.append((lo.detach(), hi.detach(),
                     tuple(w.detach() for w in walker)))
        return ta.bisect_plain(lo, hi, n_bisect, *walker)

    monkeypatch.setattr(ta, "_bisect", capture)
    with torch.no_grad():
        _solve(xs)
    monkeypatch.undo()
    (found,) = seen
    return found


def test_cpu_tensors_take_the_plain_loop():
    """On the CPU the solver runs the plain loop, launches nothing and
    still gives gradients; the kernel route refuses CPU tensors."""
    assert set(COUNTERS["armm_launches"]) == {"armm", "armm_bwd"}
    xs = [x.requires_grad_(True) for x in _inputs(8, O2_CASES[-1], 0,
                                                  torch.float32, "cpu")]
    before = counters()
    f, z, v = _solve(xs)
    grads = torch.autograd.grad((f + z).sum(), xs, allow_unused=True)
    assert counters_since(before)["armm_launches"] == {}
    assert f.shape == (8, NP + NG - 1) and 40 < v[3:].sum(-1).min()
    assert all(torch.isfinite(g[3:]).all() for g in grads[:5])
    lo = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ak.bisect(lo, lo + 1, N_BISECT,
                  *(torch.ones(2, 1) for _ in ak.ROW))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("o2", O2_CASES)
def test_backward_replay_is_autograds_gradient(dtype, o2, monkeypatch):
    """The backward kernel's recurrence as torch ops, from the plain loop's
    decisions, against autograd through the plain loop on the CPU: the
    brackets' gradients bit for bit, upstream zeros of both signs,
    subnormals, infinities and NaN included."""
    lo, hi, walker = _captured_brackets(
        _inputs(64, o2, 3, dtype, "cpu"), monkeypatch)
    lo, hi = lo.clone().requires_grad_(True), hi.clone().requires_grad_(True)
    decisions = []
    roots = ta.bisect_plain(lo, hi, N_BISECT, *walker, decisions=decisions)
    g = _special(roots.shape, dtype, "cpu", seed=4)
    want = torch.autograd.grad(roots, (lo, hi), g)
    mask = ak.pack_decisions(decisions)
    assert len(decisions) == N_BISECT and mask.dtype == torch.int64
    got = ak.replay_backward(g, mask, N_BISECT)
    for a, b, name in zip(got, want, ("lo", "hi")):
        _same_bits(a, b, f"grad {name}")
    # the decisions of a real forest go both ways
    assert 0 < int(sum(d.sum() for d in decisions)) < N_BISECT * mask.numel()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("o2", O2_CASES)
def test_the_kernels_are_the_plain_loop_on_the_card(card, dtype, o2,
                                                    monkeypatch):
    """At the dense cell's 64,512 walkers: roots, zeta, validity and the
    gradients of sum(a f + b zeta) to all eight inputs, kernel route
    against the plain loop on the card, bit for bit; one forward launch a
    solve and one backward launch a gradient, none on the plain route."""
    xs = _inputs(CELL_WALKERS, o2, 5, dtype, card)
    rng = np.random.default_rng(6)
    a, b = (torch.tensor(rng.standard_normal((CELL_WALKERS, NP + NG - 1)),
                         dtype=dtype, device=card) for _ in range(2))

    def run():
        leaves = [x.clone().requires_grad_(True) for x in xs]
        before = counters()
        f, z, v = _solve(leaves)
        grads = torch.autograd.grad((a * f + b * z).sum(), leaves,
                                    allow_unused=True)
        return f, z, v, grads, counters_since(before)["armm_launches"]

    kernel = run()
    monkeypatch.setattr(ta, "_bisect", ta.bisect_plain)
    plain = run()
    assert kernel[4] == {"armm": 1, "armm_bwd": 1}
    assert plain[4] == {}
    for k, p, name in zip(kernel[:3], plain[:3], ("freqs", "zeta", "valid")):
        _same_bits(k.detach(), p.detach(), name)
    for k, p, name in zip(kernel[3], plain[3], NAMES):
        if p is None:
            assert k is None, name
        else:
            _same_bits(k, p, f"grad {name}")
    assert 40 < plain[2][3:].sum(-1).min()       # a real forest


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_the_mask_and_the_backward_kernel_on_the_card(card, dtype,
                                                      monkeypatch):
    """The forward kernel's mask is the plain loop's decisions and its roots
    the plain loop's; the backward kernel is the replay on an upstream
    gradient of special values."""
    lo, hi, walker = _captured_brackets(
        _inputs(CELL_WALKERS, O2_CASES[-1], 7, dtype, card), monkeypatch)
    rows = torch.cat(walker, dim=-1)
    decisions = []
    with torch.no_grad():
        roots = ta.bisect_plain(lo, hi, N_BISECT, *walker,
                                decisions=decisions)
    before = counters()
    got, mask = ak.bisect_forward(lo, hi, rows, N_BISECT)
    _same_bits(got, roots, "roots")
    assert torch.equal(mask, ak.pack_decisions(decisions))
    g = _special(roots.shape, dtype, card, seed=8)
    for k, w, name in zip(ak.bisect_backward(g, mask, N_BISECT),
                          ak.replay_backward(g, mask, N_BISECT),
                          ("lo", "hi")):
        _same_bits(k, w, f"grad {name}")
    assert counters_since(before)["armm_launches"] == {"armm": 1,
                                                       "armm_bwd": 1}
