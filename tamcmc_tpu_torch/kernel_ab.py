"""Time the Lorentzian kernels alone at the main path's shapes on one GPU.

    python -m tamcmc_tpu_torch.kernel_ab --out chiprun_out/kernel_ab.json
    python -m tamcmc_tpu_torch.kernel_ab --precision both --sass
    python -m tamcmc_tpu_torch.kernel_ab --precision f64 [--chi22p]

Regimes (the shapes `chip_smoke.py` and the demos' runs give the kernels):
windowed 16x11x12,288 (the reference Pallas test's, win = 40 W); windowed
ms_global 768x54x40,000 and windowed kepler_full 1280x224x120,000 (the
demos' walkers and grids, each walker's window the one the model's static
segments are cut from, `demo_windows`); segment ms_global 768x54x40,000;
dense subgiant_mixed 1024x210x60,000; segment kepler_full
1280x224x120,000; segment reduced flagship 64x36x6,000 (the golden fit's
4 x 16 walkers, where the forward runs one walker a block and the backward
512-bin chunks).  A windowed regime's bound counts its in-window
component-bins (`lorentzian_kernel.in_window_bins`), and it prints the
in-window and visited shares of its (walker, component, bin) triples and a
sha256 of each output (values, gH, gC, gW, gB), which a run from an older
checkout prints too: equal hashes are outputs equal bit for bit.  Each
launch is enqueued through ctypes on preallocated outputs and arguments converted
once, so a time is the kernel's alone, from CUDA events around `--reps`
launches after warm-up.  Beside it stand the same call through the
package's autograd wrapper (the runs "<precision> wrapper": the path a fit
takes, host work per call included) and the roofline bound
(`lorentzian_kernel.bound_ms`).

`--precision f32 | bf16 | f64 | both | all` picks the instantiations (both:
f32 and bf16; all: the three; the windowed mode is float32 only).  f64 runs
the float64 instantiation on the regime's inputs cast to double.  Every
instantiation is first held against the plain torch version of the same
inputs and precision (run in 16-walker slices; within 1e-4, float64 within
1e-10), its backward run twice and compared bitwise; beside the largest
errors stands
the signed error toward zero, sum((got - plain) sign(plain)) / sum(|plain|)
of the values and of each gradient: a negative reading that grows with the
components a bin sums is the one-sided truncation of the tensor cores'
float32 adds, which round-to-nearest sums do not show.  Then all runs are
timed in `--turns` interleaved turns, the order reversed every other turn.
To compare two versions of the source, run this module from a checkout of
each (`git archive` into the ignored `archive/`, this file copied over the
older one's) inside one job on one card, in turns: A B B A.

`--chi22p` runs the fused likelihood instead (the segment and dense
regimes, the demo's spectrum and background through the model's own hook):
held to the unfused forward kernel plus the plain chain (logL and the
gradients in H, C, W, B and the white level, then in a per-bin background),
and timed alone against the unfused forward alone (the epilogue's cost is
the difference) and plus the chain's forward, and through the package
forward and backward against the unfused path; beside the bound stands the
MUFU floor (`mufu_floor_ms`).

With `f32` it also runs `check_clamp_path_f32`, with `f64`
`check_clamp_path`.

`--sass` writes `cuobjdump -sass` of the build beside the JSON and prints,
per kernel instantiation, its registers a thread and bytes of local memory
(`cuobjdump -res-usage`), its local-memory loads and stores (LDL / STL:
spills), and the opcode counts of every loop that holds two or more
reciprocals (`MUFU`) or a tensor-core sum (`HMMA`): a loop's dispatch
slots per component-bin are its instruction count over the component-bins
one pass covers, one reciprocal estimate each (MUFU.RCP64H, MUFU.RCP), and
it prints them beside the float64-pipe instructions per component-bin and
the loop's BSSY and CALL (a reciprocal's slow path).  For a
forward with the chi22p epilogue it prints the instructions and MUFU
results the epilogue adds to the body of the same forward without it, in
all and per (walker, bin) of a thread (static counts), and for every
kernel a hash of its code, equal in two builds that compiled the same.
Every time carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import gc
import hashlib
import json
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from tamcmc_tpu_torch.demos import make_demo
from tamcmc_tpu_torch.ops import _cuda_build
from tamcmc_tpu_torch.ops import lorentzian as L
from tamcmc_tpu_torch.ops import lorentzian_kernel as K
from tamcmc_tpu_torch.sampler.mala import default_init_scales

C = 128                   # walkers per temperature in every slice
FWD_R = 4                 # bins per forward thread (csrc/lorentzian.cu;
                          # not the package's: this file also runs against
                          # an older checkout in A/B turns)
# MUFU results the forward computes, not what the function needs: one
# reciprocal estimate per component-bin in both precisions (the bf16
# stream's two per pair), which lorentzian_kernel.bound_ms counts as one
# float32 operation; and one per (walker, bin) in the chi22p epilogue
# (1 / m, from which its three quotients come; its logarithm is a
# polynomial on the FMA pipe).
MUFU_FWD = 1
MUFU_EPILOGUE = 1


def mufu_floor_ms(bt, n, comp_bins, chi22p=False):
    """Least time of the forward's MUFU results on an H100: MUFU_FWD per
    (walker, component-bin) and, with the chi22p epilogue, MUFU_EPILOGUE per
    (walker, bin), over lorentzian_kernel.PEAK_MUFU.  A floor of this design
    (one hardware reciprocal estimate a profile value), not of the
    function."""
    mufu = bt * (MUFU_FWD * comp_bins + (MUFU_EPILOGUE * n if chi22p else 0))
    return 1e3 * mufu / K.PEAK_MUFU


def _walkers(problem, n_walkers, rng, dev):
    """n_walkers full parameter vectors drawn around params0 at the demo's
    prior-based step scales."""
    scale = torch.as_tensor(default_init_scales(problem), device=dev)
    x0 = problem.extract(problem.params0)
    u = torch.as_tensor(rng.standard_normal((n_walkers, x0.shape[0])),
                        dtype=torch.float32, device=dev)
    return problem.embed(x0 + scale * u)


def demo_components(problem, n_walkers, rng, dev):
    """(H, C, W, B) of n_walkers parameter vectors drawn around params0 at
    the demo's prior-based step scales."""
    with torch.no_grad():
        H, Cc, W, B, _ = problem.model_fn._assemble(
            _walkers(problem, n_walkers, rng, dev))
    return tuple(a.contiguous() for a in (H, Cc, W, B))


def demo_windows(problem, n_walkers, rng, dev):
    """(H, C, W, B, win) as `demo_components` draws them, with each
    walker's window from its own W by the rule the MS_Global model cuts its
    static segments with (models/ms_global.py _window_segments): win =
    trunc max(W, 1e-3) + margin, trunc the walker's layout entry (40 where
    it is 0), the margin the demo's window hint's (10 uHz)."""
    full = _walkers(problem, n_walkers, rng, dev)
    with torch.no_grad():
        H, Cc, W, B, _ = problem.model_fn._assemble(full)
    trunc = problem.layout.get(full, "trunc")
    trunc = torch.where(trunc == 0, torch.full_like(trunc, 40.0), trunc)
    margin = float(problem.model_fn._spec.window_hint[4])
    win = trunc * torch.clamp_min(W, 1e-3) + margin
    return tuple(a.contiguous() for a in (H, Cc, W, B, win))


def check_clamp_path(dev, tol=1e-10, bt=64, nc=8, n=40000, seed=5):
    """The float64 kernels' clamped loops (csrc/lorentzian.cu
    inv_f64<true>, which a block runs when one of its centres or bins lies
    past RCP64_SAFE = 2^487, or is NaN) against the plain float64 version:
    dense mode, 64 walkers (four a forward block).  Walker 0's first centre
    lies at 2^490, where 1 + x^2 stays below the clamp; walker 5's at 2^511
    with width 2, where 1 + x^2 = 2^1022 is clamped to Y_MAX = 2^1021 (the
    plain version's 1 / y = 2^-1022 against the kernel's 2^-1021); walker
    6's at 2^600, where 1 + x^2 is +inf (plain 0 against 2^-1021).  Both
    differences in inv are below 2^-1021 and every value must agree.  The
    modes and the gradients of sum(g modes), and the fused logL and the
    gradients of its sum, within `tol` (|a - b| <= tol + tol |b| for
    values, max |a - b| / max |b| for gradients); raises otherwise,
    returns the largest errors."""
    rng = np.random.default_rng(seed)

    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    nu = torch.linspace(1000.0, 1400.0, n, dtype=torch.float64, device=dev)
    C = rng.uniform(1050, 1350, (bt, nc))
    W = rng.uniform(0.5, 3, (bt, nc))
    C[0, 0], C[5, 0], W[5, 0], C[6, 0] = 2.0 ** 490, 2.0 ** 511, 2.0, \
        2.0 ** 600
    args = [f64(rng.uniform(1, 5, (bt, nc))), f64(C), f64(W),
            f64(rng.uniform(-0.1, 0.1, (bt, nc)))]
    g = f64(rng.normal(size=(bt, n)))
    spec, bg_n = f64(rng.exponential(2.0, n)), f64(rng.uniform(0.5, 1, n))
    bg_b = f64(rng.uniform(0.1, 0.3, (bt, 1)))
    plan = K.dense_plan(n, nc)
    res = {}
    for name, kernel, plain in (
            ("modes", lambda *a: L.sum_lorentzians(nu, *a),
             lambda *a: L.sum_lorentzians_plain(nu, *a)),
            ("logL", lambda *a: L.lorentzian_chi22p(nu, spec, *a, plan, bg_n,
                                                    bg_b),
             lambda *a: L.lorentzian_chi22p_plain(nu, spec, *a, plan, bg_n,
                                                  bg_b))):
        outs = []
        for f in (kernel, plain):
            leaves = [a.clone().requires_grad_(True) for a in args]
            out = f(*leaves)
            up = g if name == "modes" else torch.ones_like(out)
            outs.append((out.detach(), torch.autograd.grad(out, leaves, up)))
        (a, ga), (b, gb) = outs
        val = bool(((a - b).abs() <= tol + tol * b.abs()).all())
        rel = max(float((x - y).abs().max() / y.abs().max())
                  for x, y in zip(ga, gb))
        res[name] = {"max_abs_err": float((a - b).abs().max()),
                     "grad_max_rel_err": rel}
        if not (val and rel <= tol):
            raise AssertionError(f"float64 clamped loops, {name}: {res}")
    return res


def check_clamp_path_f32(dev, tol=1e-4, bt=64, nc=8, n=40000, seed=6):
    """The float32 backward's clamped loop (csrc/lorentzian.cu bwd_sums
    with CLAMP, which a (walker, component, chunk) runs where
    rcp_unclamped fails) against the plain version in float64: dense mode,
    components in pairs (0, 1), ..., (6, 7).  Walker 0's component 0 lies
    at 1e20 (|x| past 2^62), walker 5's component 3 at 3e12 with its width
    at the floor, walker 6's component 4 at NaN: each pair runs its two
    components one at a time, one clamped.  Walker 7's components 6 and 7
    lie at +-1e20: a clamped pair.  Values and the gradients of sum(g
    modes), NaN where the plain version is NaN, within `tol` elsewhere
    (|a - b| <= tol + tol |b| for values, |a - b| <= tol max |b| for
    gradients); and every gradient of a component left as it was equals,
    bit for bit, the same run's on unchanged inputs, whatever its partner
    runs.  Raises otherwise; returns the largest errors."""
    rng = np.random.default_rng(seed)
    nu = torch.linspace(1000.0, 1400.0, n, device=dev)
    base = [rng.uniform(*r, (bt, nc)).astype(np.float32)
            for r in ((1, 5), (1050, 1350), (0.5, 3), (-0.1, 0.1))]
    H, Cc, W, B = (a.copy() for a in base)
    Cc[0, 0], Cc[5, 3], W[5, 3], Cc[6, 4] = 1e20, 3e12, 1e-7, np.nan
    Cc[7, 6], Cc[7, 7] = 1e20, -1e20
    changed = np.zeros((bt, nc), bool)
    changed[0, 0] = changed[5, 3] = changed[6, 4] = True
    changed[7, 6] = changed[7, 7] = True
    g = torch.as_tensor(rng.normal(size=(bt, n)), dtype=torch.float32,
                        device=dev)

    def run(args, fn, dtype):
        leaves = [torch.as_tensor(np.asarray(a), dtype=dtype,
                                  device=dev).requires_grad_(True)
                  for a in args]
        out = fn(nu.to(dtype), *leaves)
        return out.detach(), torch.autograd.grad(out, leaves, g.to(dtype))
    out, grads = run((H, Cc, W, B), L.sum_lorentzians, torch.float32)
    want, want_g = run((H, Cc, W, B), L.sum_lorentzians_plain, torch.float64)
    _, clean = run(base, L.sum_lorentzians, torch.float32)
    out = out.double()
    nan_ok = bool(torch.equal(out.isnan(), want.isnan()))
    fin = ~want.isnan()
    val = float((out - want)[fin].abs().max())
    val_ok = bool(((out - want).abs() <= tol + tol * want.abs())[fin].all())
    rel, same = 0.0, True
    keep = torch.as_tensor(~changed, device=dev)
    for x, y, c in zip(grads, want_g, clean):
        x = x.double()
        nan_ok = nan_ok and bool(torch.equal(x.isnan(), y.isnan()))
        fin = ~y.isnan()
        rel = max(rel, float((x - y)[fin].abs().max() / y[fin].abs().max()))
        same = same and bool(torch.equal(x.float()[keep], c[keep]))
    res = {"max_abs_err": val, "grad_max_rel_err": rel, "nan_where_plain":
           nan_ok, "unchanged_components_bitwise": same}
    if not (val_ok and rel <= tol and nan_ok and same):
        raise AssertionError(f"float32 clamped loop: {res}")
    return res


def regime_problem(name, dev):
    """(demo problem, walkers) of a segment, dense or full-width windowed
    regime."""
    demo, temps, chains, sizes = {
        "segment ms_global": ("ms_global", 6, C, {}),
        "windowed ms_global": ("ms_global", 6, C, {}),
        "segment kepler_full": ("kepler_full", 10, C, {}),
        "windowed kepler_full": ("kepler_full", 10, C, {}),
        "dense subgiant_mixed": ("subgiant_mixed", 8, C, {}),
        "segment reduced flagship": ("ms_global", 4, 16,
                                     {"ngrid": 6000, "n_orders": 4})}[name]
    return make_demo(demo, seed=0, device=dev, **sizes)[0], temps * chains


def regime_inputs(name, dev, rng):
    """{nu, args (H, C, W, B), win or None, g, ranges (lo, hi), plain,
    wrapper}: `plain` and `wrapper` (the package's routed entry, which
    launches the kernels) take (nu, H, C, W, B[, win], precision)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def windowed(nu, args, win, g):
        nc, n = args[0].shape[1], nu.shape[0]
        return dict(nu=nu, args=tuple(args), win=win, g=g,
                    ranges=(np.zeros(nc), np.full(nc, n)),
                    plain=lambda nu_, *a, precision: L.sum_lorentzians_trunc(
                        nu_, *a),
                    wrapper=lambda nu_, *a, precision:
                        L.sum_lorentzians_trunc_batched(nu_, *a))

    if name == "windowed":
        bt, nc, n = 16, 11, 3 * 4096
        args = (f32(rng.uniform(1, 5, (bt, nc))),
                f32(rng.uniform(1050, 1350, (bt, nc))),
                f32(rng.uniform(0.5, 3, (bt, nc))),
                f32(rng.uniform(-0.1, 0.1, (bt, nc))))
        return windowed(torch.linspace(1000.0, 1400.0, n, device=dev), args,
                        40.0 * args[2], f32(rng.normal(size=(bt, n))))
    problem, n_walkers = regime_problem(name, dev)
    if name.startswith("windowed"):
        *args, win = demo_windows(problem, n_walkers, rng, dev)
        return windowed(problem.nu, args, win, f32(rng.normal(
            size=(n_walkers, problem.nu.shape[0]))))
    args = demo_components(problem, n_walkers, rng, dev)
    nu = problem.nu
    n, nc = nu.shape[0], args[0].shape[1]
    g = f32(rng.normal(size=(n_walkers, n)))
    if name.startswith("segment"):
        fn = problem.model_fn
        groups = fn._window_groups
        plans = {p: K.segment_plan(groups, nc, n, precision=p)
                 for p in K.PRECISIONS}
        return dict(nu=nu, args=args, win=None, g=g,
                    ranges=(fn._plan.comp_lo, fn._plan.comp_hi),
                    plain=lambda nu_, *a, precision:
                        L.sum_lorentzians_segments_plain(nu_, *a, groups,
                                                         precision),
                    wrapper=lambda nu_, *a, precision:
                        L.sum_lorentzians_segments(nu_, *a, groups,
                                                   plans[precision],
                                                   precision))
    return dict(nu=nu, args=args, win=None, g=g,
                ranges=(np.zeros(nc), np.full(nc, n)),
                plain=lambda nu_, *a, precision: L.sum_lorentzians_plain(
                    nu_, *a, precision),
                wrapper=lambda nu_, *a, precision: L.sum_lorentzians(
                    nu_, *a, precision))


REGIMES = ("windowed", "windowed ms_global", "windowed kepler_full",
           "segment ms_global", "dense subgiant_mixed",
           "segment kepler_full", "segment reduced flagship")
CHI_REGIMES = tuple(r for r in REGIMES if not r.startswith("windowed"))
STREAMS = {"f32": ("f32",), "bf16": ("bf16",), "f64": ("f64",),
           "both": ("f32", "bf16"), "all": ("f32", "bf16", "f64")}


def plan_precision(prec):
    """The plan's precision of a stream: f64 runs a plan in "f32" on
    float64 tensors (the tensors' own type)."""
    return "f32" if prec == "f64" else prec


def tolerance(prec):
    """What a run is held to against the plain version: |a - b| <= tol +
    tol |b| for values, max |a - b| / max |b| <= tol for gradients."""
    return 1e-10 if prec == "f64" else 1e-4


def in_stream(inp, prec):
    """`inp` with its floating tensors (and those of its tuples) in double
    for the f64 stream, else `inp` itself."""
    if prec != "f64":
        return inp

    def cast(v):
        if torch.is_tensor(v) and v.is_floating_point():
            return v.double()
        if isinstance(v, tuple) and v and torch.is_tensor(v[0]):
            return tuple(cast(t) for t in v)
        return v
    return {k: cast(v) for k, v in inp.items()}


def chi22p_inputs(problem, n_walkers, rng, dev):
    """The fused likelihood's inputs at `n_walkers` parameter vectors drawn
    around params0, through the model's own hook (Problem's fixed
    hand-off): {nu, spec, args (H, C, W, B), plan (the model's, float32),
    bg_n (N,), bg_b (Bt, 1), bg_full (Bt, N)}.  bg_n and bg_b are the
    demo's split (all Harvey terms fixed, the white level free); bg_full
    is the whole background per walker, as a free Harvey term makes it."""
    scale = torch.as_tensor(default_init_scales(problem), device=dev)
    x0 = problem.extract(problem.params0)
    u = torch.as_tensor(rng.standard_normal((n_walkers, x0.shape[0])),
                        dtype=torch.float32, device=dev)
    hook = problem.model_fn._chi22p_inputs
    fixed = (problem.params0, ~problem.priors.free_mask)
    with torch.no_grad():
        full = problem.embed(x0 + scale * u)
        H, Cc, W, B, plan, bg_n, bg_b = hook(full, problem.nu, fixed=fixed)
        bg_full = hook(full, problem.nu)[6]
    if bg_n is None or bg_b is None or bg_b.shape[-1] != 1:
        raise ValueError("the regime wants fixed Harvey terms and a free "
                         "white level")
    return dict(nu=problem.nu, spec=problem.spec,
                args=tuple(a.contiguous() for a in (H, Cc, W, B)), plan=plan,
                bg_n=bg_n, bg_b=bg_b.contiguous(),
                bg_full=bg_full.contiguous())


def chi22p_fns(inp, precision="f32", full_bg=False):
    """(fused, unfused, plain), each f(H, C, W, B, bg_b) -> logL (Bt,): the
    routed fused likelihood (on the card the forward kernel with its
    epilogue), the unfused forward kernel plus the plain chain, and the
    plain version; bg_b is inp's bg_b (with bg_n) or, with `full_bg`, its
    bg_full (no bg_n).  `precision` is the plan's (f64: "f32" on inp's
    float64 tensors)."""
    from tamcmc_tpu_torch.stats.likelihoods import likelihood_chi22p
    precision = plan_precision(precision)
    plan0, nu, spec = inp["plan"], inp["nu"], inp["spec"]
    if plan0.segments is not None:
        plan = K.segment_plan(plan0.segments, plan0.ncomp, plan0.n_bins,
                              precision=precision)
    else:
        plan = K.dense_plan(plan0.n_bins, plan0.ncomp, precision=precision)
    bg_n = None if full_bg else inp["bg_n"]

    def fused(h, c, w, b, bb):
        return L.lorentzian_chi22p(nu, spec, h, c, w, b, plan, bg_n, bb,
                                   precision)

    def unfused(h, c, w, b, bb):
        if plan.segments is not None:
            modes = L.sum_lorentzians_segments(nu, h, c, w, b, plan.segments,
                                               plan, precision)
        else:
            modes = L.sum_lorentzians(nu, h, c, w, b, precision)
        bg = bb if bg_n is None else bg_n + bb
        return likelihood_chi22p(spec, modes + bg)

    def plain(h, c, w, b, bb):
        return L.lorentzian_chi22p_plain(nu, spec, h, c, w, b, plan, bg_n,
                                         bb, precision)
    return fused, unfused, plain


def upstream(rng, bt, dev):
    """An upstream gradient of logL for the checks: 1/2, 1 or 2 per walker.
    Powers of two scale every rounding alike, so go g (the backward's
    staging) is the chain's go (S/m)/m + (-go)/m bit for bit, and the bf16
    stream, which rounds it to bf16, sees the same values."""
    return torch.as_tensor(2.0 ** rng.integers(-1, 2, bt),
                           dtype=torch.float32, device=dev)


def check_chi22p(label, inp, precision, full_bg, go, tol=1e-4):
    """The fused likelihood against the unfused forward kernel plus the
    plain chain on the same inputs: logL within |a - b| <= tol + tol |b|,
    the gradients of sum(go logL) in H, C, W, B and bg_b within tol of
    each one's max, every value finite, and a second forward and backward
    bitwise equal to the first.  Raises otherwise; returns the errors."""
    fused, unfused, _ = chi22p_fns(inp, precision, full_bg)
    args = (*inp["args"], inp["bg_full"] if full_bg else inp["bg_b"])
    runs = []
    for f in (fused, fused, unfused):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = f(*leaves)
        runs.append((out.detach(), torch.autograd.grad(out, leaves, go)))
        del out, leaves
    (o1, g1), (o2, g2), (ow, gw) = runs
    same = torch.equal(o1, o2) and all(torch.equal(a, b)
                                       for a, b in zip(g1, g2))
    err = (o1 - ow).abs()
    rels = [float((a - b).abs().max() / (b.abs().max() + 1e-30))
            for a, b in zip(g1, gw)]
    finite = bool(torch.isfinite(o1).all()) and all(
        bool(torch.isfinite(a).all()) for a in g1)
    res = {"max_abs_err": float(err.max()),
           "max_rel_err": float((err / ow.abs()).max()),
           "grad_max_rel_err": max(rels),
           "grad_rel": dict(zip(("H", "C", "W", "B", "bg_b"), rels)),
           "bitwise_repeatable": same}
    if not (bool((err <= tol + tol * ow.abs()).all()) and max(rels) <= tol
            and same and finite):
        raise AssertionError(f"{label}: fused likelihood against the "
                             f"unfused kernel and the chain: {res}, finite "
                             f"{finite}")
    return res


def prepare_chi22p(inp, precision="f32"):
    """The fused forward's launch (g written, as a fit's step writes it) on
    preallocated outputs, arguments converted once, with inp's bg_n and
    bg_b; returns (fwd, logL, g).  f64 launches the float64 instantiation
    on inp's float64 tensors."""
    nu, (H, Cc, W, B) = inp["nu"], inp["args"]
    bt, n = H.shape[0], nu.shape[0]
    lo, hi = inp["plan"].comp_lo, inp["plan"].comp_hi
    plan = K.LorentzPlan(lo, hi, n, precision=plan_precision(precision))
    K._check(nu, (H, Cc, W, B), None, plan)
    spec = inp["spec"].reshape(1, n).contiguous()
    bg_n = inp["bg_n"].reshape(1, n).contiguous()
    bg_b = inp["bg_b"].reshape(bt).contiguous()
    g = torch.empty((bt, n), dtype=nu.dtype, device=nu.device)
    partial = torch.empty((bt, plan.n_tiles, 2), dtype=nu.dtype,
                          device=nu.device)
    logL, gsum = (torch.empty(bt, dtype=nu.dtype, device=nu.device)
                  for _ in range(2))
    t = plan.tensors(nu.device)[:5]
    ptrs = (*map(K._ptr, (nu, H, Cc, W, B, *t, spec, bg_n, bg_b, g, partial,
                          plan.tickets(bt, nu.device, "fwd"), logL, gsum)),
            bt, H.shape[1], n, plan.n_tiles, bt, 0)
    tail = (K._vec_ok(n, nu, spec, bg_n, g), K._stream(nu.device))
    lib = K._lib()
    if precision == "f64":
        launch = lib.lorentz_fwd_chi22p_f64
        args = (*ptrs, int(plan.wide_forward(bt, K.FWD_W64)), *tail)
    else:
        launch = lib.lorentz_fwd_chi22p
        args = (*ptrs, int(precision == "bf16"), int(plan.wide_forward(bt)),
                *tail)

    def fwd(_keep=(plan, spec, bg_n, bg_b, g, partial, logL, gsum)):
        K._raise_on(launch(*args), "lorentz_fwd_chi22p")
    return fwd, logL, g


def prepare(inp, precision="f32"):
    """Plan, outputs and scratch for one regime's inputs in `precision`
    (f64: inp's tensors are float64); returns the (fwd, bwd) launch
    closures and the tensors they write."""
    nu, (H, Cc, W, B), win, g = inp["nu"], inp["args"], inp["win"], inp["g"]
    bt = H.shape[0]
    n = nu.shape[0]
    lo, hi = inp["ranges"]
    out = torch.empty((bt, n), dtype=nu.dtype, device=nu.device)
    grads = tuple(torch.empty_like(H) for _ in range(4))
    plan = K.LorentzPlan(lo, hi, n, windowed=win is not None,
                         precision=plan_precision(precision))
    K._check(nu, (H, Cc, W, B), win, plan)
    f_args = K.fwd_args(plan, nu, H, Cc, W, B, win, out)
    f64 = precision == "f64"
    # an older checkout's for_walkers takes no type (A/B turns)
    plan_b = plan.for_walkers(bt, nu.dtype) if f64 else plan.for_walkers(bt)
    scratch = K.bwd_scratch(plan_b, bt, nu.device)
    b_args = K.bwd_args(plan_b, nu, g, H, Cc, W, B, win, scratch, grads)
    lib = K._lib()
    fwd_fn, bwd_fn = ((lib.lorentz_fwd_f64, lib.lorentz_bwd_f64) if f64
                      else (lib.lorentz_fwd, lib.lorentz_bwd))

    # the arguments are converted once, so a call costs the host little
    # more than the launch itself; the closures keep every tensor their
    # pointers name alive, whether or not the caller keeps the outputs
    def fwd(_keep=(plan, plan_b, scratch, out)):
        K._raise_on(fwd_fn(*f_args), "lorentz_fwd")

    def bwd(_keep=(plan_b, scratch, g, grads)):
        K._raise_on(bwd_fn(*b_args), "lorentz_bwd")
    return fwd, bwd, out, grads


def _time_ms(fn, reps=20, warmup=3):
    """CUDA-event ms of one call of `fn`, the mean of `reps` after `warmup`
    calls, with the garbage collector held off (as timeit does)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
    finally:
        if collecting:
            gc.enable()
    return start.elapsed_time(stop) / reps


def _plain(inp, precision, step=16):
    """Values and gradients of sum(g * out) from the plain version in
    `precision`, run on `step`-walker slices of the inputs (walkers are
    independent)."""
    outs, grads = [], []
    extra = (inp["win"],) if inp["win"] is not None else ()
    for lo in range(0, inp["g"].shape[0], step):
        part = [a[lo:lo + step].clone().requires_grad_(True)
                for a in inp["args"]]
        out = inp["plain"](inp["nu"], *part,
                           *(w[lo:lo + step] for w in extra),
                           precision=plan_precision(precision))
        grads.append(torch.autograd.grad(out, part, inp["g"][lo:lo + step]))
        outs.append(out.detach())
    return torch.cat(outs), [torch.cat(p) for p in zip(*grads)]


def _wrapper(inp, precision):
    """(fwd, bwd) closures through the package's routed entry point: the
    forward without autograd, the backward of one retained graph."""
    extra = (inp["win"],) if inp["win"] is not None else ()
    leaves = [a.clone().requires_grad_(True) for a in inp["args"]]
    precision = plan_precision(precision)
    out = inp["wrapper"](inp["nu"], *leaves, *extra, precision=precision)

    def fwd():
        with torch.no_grad():
            inp["wrapper"](inp["nu"], *inp["args"], *extra,
                           precision=precision)

    def bwd():
        torch.autograd.grad(out, leaves, inp["g"], retain_graph=True)
    return fwd, bwd


def _toward_zero(got, want):
    """sum((got - want) sign(want)) / sum(|want|): the signed error of `got`
    toward zero (negative) or away from it, relative to the sum."""
    return float(((got.double() - want.double()) * want.sign()).sum()
                 / want.double().abs().sum().clamp_min(1e-300))


def _check_against(label, out, grads, first, want_out, want_grads,
                   tol=1e-4):
    """Errors of one instantiation against the plain version; raises past
    chip_smoke's tolerance `tol` or if two backward runs differ in any
    bit."""
    val_err = float((out - want_out).abs().max())
    val_ok = bool(((out - want_out).abs()
                   <= tol + tol * want_out.abs()).all())
    rel = max(float((x - y).abs().max() / (y.abs().max() + 1e-30))
              for x, y in zip(grads, want_grads))
    same = all(torch.equal(x, y) for x, y in zip(first, grads))
    if not (val_ok and rel <= tol and same):
        raise AssertionError(
            f"{label}: values max abs err {val_err}, grads max rel err "
            f"{rel}, repeatable {same}")
    return {"max_abs_err": val_err, "grad_max_rel_err": rel,
            "bwd_bitwise_repeatable": same,
            "val_toward_zero": _toward_zero(out, want_out),
            "grad_toward_zero": [_toward_zero(x, y)
                                 for x, y in zip(grads, want_grads)]}


def _kernel_label(mangled):
    """`lorentz_fwd_kernel<0,4>` from the mangled name of a template
    instantiation (its bool and int template arguments in order)."""
    m = re.match(r"_Z\d+(\w+?)I((?:L[bi]\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'L[bi](\d+)E', m.group(2)))}>"


def _parse_sass(text):
    """Per kernel instantiation of `cuobjdump -sass` text: {"instructions"
    (the body up to its closing self-branch, without the out-of-line
    slow-path subroutines after it), "ops" (opcode counts of that body,
    MUFU by function), "ldl", "stl" (local-memory loads and stores: spills),
    "sha" (of the whole function's code: equal in two builds when the
    compiler made the same code), "loops"}: "loops" lists, for each loop (a
    backward branch and its target) that holds at least two reciprocals
    (`MUFU`) or a tensor-core instruction, {"instructions": n, "ops":
    {...}}."""
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"^\s+/\*([0-9a-f]{4,5})\*/\s+(?:@!?U?P\w+\s+)?(.*?);", func,
            re.M)]
        code = hashlib.sha256(" ".join(re.findall(
            r"/\* (0x[0-9a-f]{16}) \*/", func)).encode()).hexdigest()[:16]
        at = {addr: i for i, (addr, _) in enumerate(ins)}
        end, found = len(ins), []
        for i, (addr, op) in enumerate(ins):
            m = re.match(r"BRA\S*\s+(?:\S+,\s+)?0x([0-9a-f]+)", op)
            if not m or int(m.group(1), 16) > addr:
                continue
            if int(m.group(1), 16) == addr:      # the body's closing trap
                end = min(end, i)
                continue
            body = ins[at[int(m.group(1), 16)]:i + 1]
            ops = collections.Counter(
                o.split()[0].split(".")[0] for _, o in body)
            if ops["MUFU"] >= 2 or ops["HMMA"]:
                found.append(_loop_counts(body, ops))
        names = [o.split()[0] for _, o in ins[:end]]
        ops = collections.Counter(
            n if n.startswith("MUFU") else n.split(".")[0] for n in names)
        out[_kernel_label(func.split("\n", 1)[0].strip())] = {
            "instructions": end, "ops": dict(ops.most_common()),
            "ldl": ops["LDL"], "stl": ops["STL"], "sha": code, "loops": found}
    return out


# opcodes that issue to the float64 pipe
F64_PIPE = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX", "DSET")


def _loop_counts(body, ops):
    """{"instructions", "ops"} of one loop's SASS body and, where it holds
    reciprocal estimates (MUFU.RCP64H in float64, MUFU.RCP in float32: one
    a component-bin in each forward and backward loop), the component-bins
    one pass covers ("rcp"), its instructions and float64-pipe
    instructions per component-bin, and its BSSY and CALL instructions
    (the convergence region and call of a reciprocal's slow path)."""
    full = collections.Counter(o.split()[0] for _, o in body)
    rcp = full["MUFU.RCP64H"] or full["MUFU.RCP"]
    f64 = sum(ops[op] for op in F64_PIPE)
    out = {"instructions": len(body), "ops": dict(ops.most_common()),
           "bssy": ops["BSSY"], "call": ops["CALL"], "f64_pipe": f64,
           "rcp": rcp}
    if rcp:
        out["per_comp_bin"] = len(body) / rcp
        out["f64_pipe_per_comp_bin"] = f64 / rcp
    return out


def _parse_res_usage(text):
    """{kernel label: {"registers", "local_bytes", "shared_bytes"}} from
    `cuobjdump -res-usage` text."""
    return {_kernel_label(m.group(1)): {
        "registers": int(m.group(2)), "local_bytes": int(m.group(4)),
        "shared_bytes": int(m.group(3))} for m in re.finditer(
            r"Function (\S+?):\s+REG:(\d+) STACK:\d+ SHARED:(\d+) "
            r"LOCAL:(\d+)", text)}


def _without_epilogue(label):
    """(the forward without the chi22p epilogue that `label` is measured
    against, its walkers a block) for a forward with it, else None: one
    template with a CHI argument (`<..., 1>` against `<..., 0>`), or the
    kernels of their own (`lorentz_fwd_chi22p_kernel<W>` against
    `lorentz_fwd_kernel<0,W>`, `lorentz_fwd_bf16_chi22p_kernel<W>` against
    `lorentz_fwd_bf16_kernel<W>`, `lorentz_fwd_f64_chi22p_kernel<W>`
    against `lorentz_fwd_f64_kernel<W>`)."""
    m = re.fullmatch(r"(lorentz_fwd(?:_bf16)?_kernel)<(.*),1>", label)
    if m:
        return f"{m.group(1)}<{m.group(2)},0>", int(m.group(2).split(",")[-1])
    m = re.fullmatch(r"lorentz_fwd(_bf16|_f64)?_chi22p_kernel<(\d+)>", label)
    if m:
        wpb = m.group(2)
        return (f"lorentz_fwd{m.group(1)}_kernel<{wpb}>" if m.group(1)
                else f"lorentz_fwd_kernel<0,{wpb}>"), int(wpb)
    return None


def _epilogues(kernels):
    """The chi22p epilogue's cost from the SASS of each forward with it
    against the same forward without it (`_without_epilogue`): instructions
    and MUFU results added to the body, in all and per (walker, bin) of a
    thread (WPB x FWD_R).  Static counts: the load paths of a ragged tile
    and the slow path of the quotients are in the body, so they overstate
    what one thread runs."""
    out = {}
    for label, k in kernels.items():
        pair = _without_epilogue(label)
        if not pair or pair[0] not in kernels or "ops" not in k:
            continue
        base = kernels[pair[0]]
        per = pair[1] * FWD_R
        mufu = {op: n - base["ops"].get(op, 0) for op, n in k["ops"].items()
                if op.startswith("MUFU")}
        added = k["instructions"] - base["instructions"]
        out[label] = {"walker_bins": per, "instructions": added,
                      "mufu": mufu,
                      "instructions_per_walker_bin": added / per,
                      "mufu_per_walker_bin": sum(mufu.values()) / per}
    return out


def _sass(path, out_file):
    """Write `cuobjdump -sass` of `path` to `out_file` and return per kernel
    instantiation its registers and local memory (`cuobjdump -res-usage`),
    its SASS counts (`_parse_sass`) and, for a forward with the chi22p
    epilogue, the epilogue's (`_epilogues`, under "epilogue")."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def run(flag):
        return subprocess.run([tool, flag, str(path)], capture_output=True,
                              text=True, check=True).stdout
    text = run("-sass")
    out_file.write_text(text)
    kernels = _parse_sass(text)
    for label, res in _parse_res_usage(run("-res-usage")).items():
        kernels.setdefault(label, {}).update(res)
    for label, epi in _epilogues(kernels).items():
        kernels[label]["epilogue"] = epi
    return kernels


def _print_sass(kernels):
    for kern, k in kernels.items():
        print(f"sass {kern}: {k.get('registers')} registers, "
              f"{k.get('local_bytes')} bytes local, {k.get('ldl')} LDL / "
              f"{k.get('stl')} STL, {k.get('instructions')} instructions, "
              f"code {k.get('sha')}")
        epi = k.get("epilogue")
        if epi:
            print(f"sass {kern}: epilogue +{epi['instructions']} "
                  f"instructions, MUFU {epi['mufu']}: "
                  f"{epi['instructions_per_walker_bin']:.2f} instructions "
                  f"and {epi['mufu_per_walker_bin']:.2f} MUFU a (walker, "
                  f"bin) over {epi['walker_bins']} a thread")
        for loop in k.get("loops", ()):
            per = ""
            if "per_comp_bin" in loop:
                per = (f" ({loop['rcp']} component-bins a pass: "
                       f"{loop['per_comp_bin']:.2f} instructions and "
                       f"{loop['f64_pipe_per_comp_bin']:.2f} on the float64 "
                       f"pipe a component-bin; BSSY {loop['bssy']}, CALL "
                       f"{loop['call']})")
            print(f"sass {kern}: loop of {loop['instructions']} "
                  f"instructions{per} {loop['ops']}")
        if kern == "lorentz_bwd_kernel<0,0>":
            for comps, clamped, per in group_loops(k.get("loops", ())):
                print(f"sass {kern}: "
                      f"{'pair' if comps == 2 else f'{comps:g}-component'} "
                      f"loop {'with' if clamped else 'without'} the clamp: "
                      f"{per:.2f} instructions a component-bin")


def group_loops(loops):
    """(components, clamped, instructions a component-bin) of each inner
    loop of a float32 backward (`_parse_sass` loops without a shuffle):
    a float4 group of 4 bins takes two shared loads (nu, g), so a pass over
    rcp component-bins covers rcp / (2 LDS) components; clamped where the
    loop holds an FMNMX (fminf(y, 2^125) before the reciprocal)."""
    return [(loop["rcp"] / (2 * loop["ops"]["LDS"]),
             bool(loop["ops"].get("FMNMX")), loop["per_comp_bin"])
            for loop in loops if loop.get("rcp") and loop["ops"].get("LDS")
            and not loop["ops"].get("SHFL")]


def window_shares(nu, C, win):
    """A windowed regime's work, from its inputs (tensors or arrays): the
    in-window component-bins per walker (|fl(nu - c)| <= win,
    `lorentzian_kernel.in_window_bins`) and the shares of its (walker,
    component, bin) triples that lie in the window and in the tiles
    (forward) and chunks (backward) the kernels visit
    (`lorentzian_kernel.window_visits`, with the blocks the launch takes:
    FWD_W walkers a forward block or 1, the backward's chunk for Bt)."""
    nu, C, win = (np.asarray(a.cpu() if torch.is_tensor(a) else a,
                             np.float32) for a in (nu, C, win))
    bt, nc = C.shape
    n = nu.shape[0]
    triples = bt * nc * n
    inside = int(K.in_window_bins(nu, C, win).sum())
    plan = K.dense_plan(n, nc, windowed=True)
    out = {"in_window_comp_bins_per_walker": inside / bt,
           "in_window_share": inside / triples}
    for kind, width, group in (
            ("fwd", plan.tile, K.FWD_W if plan.wide_forward(bt) else 1),
            ("bwd", plan.for_walkers(bt).chunk, 1)):
        vis = K.window_visits(nu, C, win, width, group)
        bins = np.minimum(width, n - width * np.arange(vis.shape[2]))
        walkers = np.minimum(group, bt - group * np.arange(vis.shape[0]))
        out[f"visited_share_{kind}"] = float(
            walkers @ (vis.sum(1) @ bins)) / triples
    return out


def unclamped_share(nu, C, W, ranges):
    """Share of the float32 backward's (walker, component, chunk) ranges
    that run its loop without the reciprocal's clamp, by the rule
    (`lorentzian_kernel.unclamped`) on the regime's inputs and the chunks of
    the plan its launch takes: computed here, not read from the card (the
    kernel decides per range on the device and counts nothing)."""
    nu, C, W = (np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float32)
                for a in (nu, C, W))
    lo, hi = ranges
    plan = K.LorentzPlan(lo, hi, nu.shape[0]).for_walkers(C.shape[0])
    fast = K.unclamped(nu, C, W, plan.chunk)
    chunk_of = np.repeat(np.arange(plan.n_chunks), np.diff(plan.chunk_ptr))
    return float(fast[:, plan.chunk_comp, chunk_of].mean())


def _sha(t):
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def _max_cover(lo, hi, n):
    """Most components whose range holds one bin: the float32 terms the
    forward sums into a bin."""
    edges = np.zeros(n + 1, np.int64)
    keep = hi > lo
    np.add.at(edges, lo[keep], 1)
    np.add.at(edges, hi[keep], -1)
    return int(np.cumsum(edges)[:n].max())


def _chi22p_regime(name, dev, rng, precisions, a, smi):
    """Check and time the fused likelihood at one regime: the kernel alone
    against the unfused forward alone plus the chain's forward, and both
    through the package (forward and backward), in turns."""
    from tamcmc_tpu_torch.stats.likelihoods import likelihood_chi22p
    problem, n_walkers = regime_problem(name, dev)
    inp32 = chi22p_inputs(problem, n_walkers, rng, dev)
    inp = inp32
    del problem
    (H, Cc, W, B), nu, spec = inp["args"], inp["nu"], inp["spec"]
    bt, nc, n = H.shape[0], H.shape[1], nu.shape[0]
    comp_bins = inp["plan"].comp_bins()
    go = upstream(rng, bt, dev)
    bg = inp["bg_n"] + inp["bg_b"]
    reg = {"bt": bt, "nc": nc, "n": n, "comp_bins_per_walker": comp_bins,
           "runs": {}}
    launch = {}
    for prec in precisions:
        inp = in_stream(inp32, prec)
        for full_bg in (False, True):
            key = f"check {prec} bg_b {'(Bt, N)' if full_bg else '(Bt,)'}"
            reg[key] = check_chi22p(f"{name} {key}", inp, prec, full_bg,
                                    go.to(inp["nu"].dtype),
                                    tol=tolerance(prec))
        fwd_chi, _, _ = prepare_chi22p(inp, prec)
        fwd, _, out, _ = prepare(dict(
            nu=inp["nu"], args=inp["args"], win=None,
            g=torch.empty((bt, n), dtype=inp["nu"].dtype, device=dev),
            ranges=(inp["plan"].comp_lo, inp["plan"].comp_hi)), prec)

        def unfused_alone(fwd=fwd, out=out, spec=inp["spec"],
                          bg=in_stream({"bg": bg}, prec)["bg"]):
            fwd()
            likelihood_chi22p(spec, out + bg)
        fused, unfused, _ = chi22p_fns(inp, prec)
        leaves = [t.clone().requires_grad_(True)
                  for t in (*inp["args"], inp["bg_b"])]

        def through(f, leaves=leaves):
            return lambda: torch.autograd.grad(f(*leaves).sum(), leaves)
        launch[f"{prec} fused kernel"] = fwd_chi
        launch[f"{prec} unfused kernel"] = fwd
        launch[f"{prec} unfused kernel + chain"] = unfused_alone
        launch[f"{prec} fused fwd+bwd"] = through(fused)
        launch[f"{prec} unfused + chain fwd+bwd"] = through(unfused)
        reg["runs"].update({k: [] for k in launch if k.startswith(prec)})
        reg[f"{prec} bound_ms"], reg[f"{prec} bound_by"] = K.bound_ms(
            "fwd_chi22p", bt, nc, n, comp_bins, precision=prec)
        reg[f"{prec} mufu_floor_ms"] = mufu_floor_ms(bt, n, comp_bins,
                                                     chi22p=True)
    order = list(launch)
    torch.cuda.reset_peak_memory_stats()
    for turn in range(a.turns):
        for key in order if turn % 2 == 0 else order[::-1]:
            reg["runs"][key].append(_time_ms(launch[key], a.reps))
    for key, times in reg["runs"].items():
        print(f"chi22p {name} ({bt}x{nc}x{n}) {key}: "
              f"{' '.join(f'{t:.4f}' for t in times)} ms  [{smi}]")
    for prec in precisions:
        print(f"chi22p {name} {prec}: bound {reg[f'{prec} bound_ms']:.4f} ms "
              f"by {reg[f'{prec} bound_by']}, MUFU floor "
              f"{reg[f'{prec} mufu_floor_ms']:.4f} ms; "
              + "; ".join(f"{k}: logL max rel {v['max_rel_err']:.2e}, grads "
                          f"max rel {v['grad_max_rel_err']:.2e}"
                          for k, v in reg.items()
                          if k.startswith(f"check {prec}")))
    del inp, inp32, launch
    torch.cuda.empty_cache()
    return reg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--regime", action="append", choices=REGIMES)
    ap.add_argument("--precision", choices=tuple(STREAMS), default="f32")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--chi22p", action="store_true",
                    help="the forward with the likelihood's epilogue "
                         "against the unfused forward plus the chain, at "
                         "the segment and dense regimes")
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}")
    out_path = pathlib.Path(a.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    precisions = STREAMS[a.precision]

    info = _cuda_build.build("lorentzian")
    print(f"build: {info['seconds']:.1f} s\n{info['log'].strip()}")
    result = {"device": smi, "reps": a.reps, "turns": a.turns,
              "precisions": list(precisions), "regimes": {},
              "rcp_mismatches": K.rcp_mismatches(dev)}
    print(f"reciprocal: {result['rcp_mismatches']} floats in [2^-126, 2^125]"
          " differ from the correctly rounded 1/y")
    if a.sass:
        result["sass"] = _sass(info["path"], out_path.with_suffix(".sass"))
        _print_sass(result["sass"])

    if "f32" in precisions:
        result["clamp_path_f32"] = check_clamp_path_f32(dev)
        print(f"float32 clamped loop against the plain float64 version: "
              f"{result['clamp_path_f32']}")
    if "f64" in precisions:
        result["clamp_path"] = check_clamp_path(dev)
        print(f"float64 clamped loops against the plain float64 version: "
              f"{result['clamp_path']}")
    rng = np.random.default_rng(0)
    if a.chi22p:
        result["chi22p"] = {
            name: _chi22p_regime(name, dev, rng, precisions, a, smi)
            for name in a.regime or CHI_REGIMES if name in CHI_REGIMES}
        out_path.write_text(json.dumps(result, indent=1))
        print(f"wrote {out_path}")
        return 0
    for name in a.regime or REGIMES:
        inp = regime_inputs(name, dev, rng)
        bt, nc = inp["args"][0].shape
        n = inp["nu"].shape[0]
        windowed = inp["win"] is not None
        lo, hi = (np.asarray(r, np.int64) for r in inp["ranges"])
        comp_bins = int(np.maximum(hi - lo, 0).sum())
        reg = {"bt": bt, "nc": nc, "n": n, "comp_bins_per_walker": comp_bins,
               "max_components_a_bin": _max_cover(lo, hi, n),
               "max_bins_a_component": int(np.maximum(hi - lo, 0).max()),
               "runs": {}}
        # the function's work bounds a windowed regime
        if windowed:
            reg.update(window_shares(inp["nu"], inp["args"][1], inp["win"]))
            comp_bins = reg["in_window_comp_bins_per_walker"]
            print(f"{name} ({bt}x{nc}x{n}): in-window share "
                  f"{reg['in_window_share']:.4f}, visited share forward "
                  f"{reg['visited_share_fwd']:.4f}, backward "
                  f"{reg['visited_share_bwd']:.4f} of the (walker, "
                  f"component, bin) triples; {comp_bins:.1f} in-window "
                  "component-bins a walker")
        if "f32" in precisions:
            reg["unclamped_share_by_rule"] = unclamped_share(
                inp["nu"], inp["args"][1], inp["args"][2], inp["ranges"])
            print(f"{name} ({bt}x{nc}x{n}): "
                  f"{reg['unclamped_share_by_rule']:.4f} of the float32 "
                  "backward's (walker, component, chunk) ranges without the "
                  "reciprocal's clamp (by the rule, from the inputs)")
        launch = {}
        inp32 = inp
        for prec in precisions:
            if windowed and prec != "f32":
                continue
            inp = in_stream(inp32, prec)
            want = _plain(inp, prec)
            fwd, bwd, out, grads = prepare(inp, prec)
            fwd()
            bwd()
            torch.cuda.synchronize()
            first = [t.clone() for t in grads]
            bwd()
            torch.cuda.synchronize()
            run = _check_against(f"{name} {prec}", out, grads, first, *want,
                                 tol=tolerance(prec))
            if windowed:
                run["sha256"] = dict(zip(("values", "gH", "gC", "gW", "gB"),
                                         map(_sha, (out, *grads))))
                print(f"{name} ({bt}x{nc}x{n}) {prec} sha256: "
                      + ", ".join(f"{k} {v}" for k, v in run["sha256"].items()))
            for kind in ("fwd", "bwd"):
                run[f"{kind}_bound_ms"], run[f"{kind}_bound_by"] = \
                    K.bound_ms(kind, bt, nc, n, comp_bins, windowed, prec)
                run[f"{kind}_ms"] = []
            reg["runs"][f"{prec} kernel"] = run
            launch[f"{prec} kernel"] = (fwd, bwd, out, grads)
            fwd, bwd = _wrapper(inp, prec)
            reg["runs"][f"{prec} wrapper"] = {"fwd_ms": [], "bwd_ms": []}
            launch[f"{prec} wrapper"] = (fwd, bwd)
            del want, first
        order = list(launch)
        for turn in range(a.turns):
            for key in order if turn % 2 == 0 else order[::-1]:
                fwd, bwd = launch[key][:2]
                reg["runs"][key]["fwd_ms"].append(_time_ms(fwd, a.reps))
                reg["runs"][key]["bwd_ms"].append(_time_ms(bwd, a.reps))
        print(f"{name} ({bt}x{nc}x{n}): at most "
              f"{reg['max_components_a_bin']} components a bin, "
              f"{reg['max_bins_a_component']} bins a component")
        for key, run in reg["runs"].items():
            extra = ""
            if "fwd_bound_ms" in run:
                extra = (f" (bound {run['fwd_bound_ms']:.4f} / "
                         f"{run['bwd_bound_ms']:.4f}; err "
                         f"{run['max_abs_err']:.2e} / "
                         f"{run['grad_max_rel_err']:.2e}; toward zero "
                         f"{run['val_toward_zero']:.2e} / "
                         + " ".join(f"{b:.2e}"
                                    for b in run["grad_toward_zero"]) + ")")
            print(f"{name} ({bt}x{nc}x{n}) {key}: fwd "
                  f"{' '.join(f'{t:.4f}' for t in run['fwd_ms'])} ms, bwd "
                  f"{' '.join(f'{t:.4f}' for t in run['bwd_ms'])} ms"
                  f"{extra}  [{smi}]")
        result["regimes"][name] = reg
        del inp, inp32, launch
        torch.cuda.empty_cache()
    out_path.write_text(json.dumps(result, indent=1))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
