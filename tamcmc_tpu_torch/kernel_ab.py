"""Time the Lorentzian kernels alone at the main path's shapes on one GPU.

    python -m tamcmc_tpu_torch.kernel_ab --out chiprun_out/kernel_ab.json
    python -m tamcmc_tpu_torch.kernel_ab --precision both --sass

Regimes (the shapes `chip_smoke.py` and the demos' runs give the kernels):
windowed 16x11x12,288; segment ms_global 768x54x40,000; dense subgiant_mixed
1024x210x60,000; segment kepler_full 1280x224x120,000; segment reduced
flagship 64x36x6,000 (the golden fit's 4 x 16 walkers, where the forward
runs one walker a block and the backward 512-bin chunks).  Each launch is
enqueued through ctypes on preallocated outputs and arguments converted
once, so a time is the kernel's alone, from CUDA events around `--reps`
launches after warm-up.  Beside it stand the same call through the
package's autograd wrapper (the runs "<precision> wrapper": the path a fit
takes, host work per call included) and the roofline bound
(`lorentzian_kernel.bound_ms`).

`--precision f32 | bf16 | both` picks the instantiations (the windowed mode
is float32 only).  Every instantiation is first held against the plain torch
version of the same inputs and precision (run in 16-walker slices), its
backward run twice and compared bitwise; beside the largest errors stands
the signed error toward zero, sum((got - plain) sign(plain)) / sum(|plain|)
of the values and of each gradient: a negative reading that grows with the
components a bin sums is the one-sided truncation of the tensor cores'
float32 adds, which round-to-nearest sums do not show.  Then all runs are
timed in `--turns` interleaved turns, the order reversed every other turn.
To compare two versions of the source, run this module from a checkout of
each (`git archive` into the ignored `archive/`, this file copied over the
older one's) inside one job on one card, in turns: A B B A.

`--sass` writes `cuobjdump -sass` of the build beside the JSON and prints,
per kernel instantiation, the opcode counts of every loop that holds two or
more reciprocals (`MUFU`) or a tensor-core sum (`HMMA`): a loop's dispatch
slots per component-bin are its instruction count over the component-bins
one pass covers (PERF.md section 6 gives the count for each loop).  Every
time carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import gc
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


def demo_components(problem, n_walkers, rng, dev):
    """(H, C, W, B) of n_walkers parameter vectors drawn around params0 at
    the demo's prior-based step scales."""
    scale = torch.as_tensor(default_init_scales(problem), device=dev)
    x0 = problem.extract(problem.params0)
    u = torch.as_tensor(rng.standard_normal((n_walkers, x0.shape[0])),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        H, Cc, W, B, _ = problem.model_fn._assemble(
            problem.embed(x0 + scale * u))
    return tuple(a.contiguous() for a in (H, Cc, W, B))


def regime_inputs(name, dev, rng):
    """{nu, args (H, C, W, B), win or None, g, ranges (lo, hi), plain,
    wrapper}: `plain` and `wrapper` (the package's routed entry, which
    launches the kernels) take (nu, H, C, W, B[, win], precision)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    if name == "windowed":
        bt, nc, n = 16, 11, 3 * 4096
        nu = torch.linspace(1000.0, 1400.0, n, device=dev)
        args = (f32(rng.uniform(1, 5, (bt, nc))),
                f32(rng.uniform(1050, 1350, (bt, nc))),
                f32(rng.uniform(0.5, 3, (bt, nc))),
                f32(rng.uniform(-0.1, 0.1, (bt, nc))))
        win = 40.0 * args[2]
        return dict(nu=nu, args=args, win=win, g=f32(rng.normal(size=(bt, n))),
                    ranges=(np.zeros(nc), np.full(nc, n)),
                    plain=lambda nu_, *a, precision: L.sum_lorentzians_trunc(
                        nu_, *a),
                    wrapper=lambda nu_, *a, precision:
                        L.sum_lorentzians_trunc_batched(nu_, *a))
    demo, temps, chains, sizes = {
        "segment ms_global": ("ms_global", 6, C, {}),
        "segment kepler_full": ("kepler_full", 10, C, {}),
        "dense subgiant_mixed": ("subgiant_mixed", 8, C, {}),
        "segment reduced flagship": ("ms_global", 4, 16,
                                     {"ngrid": 6000, "n_orders": 4})}[name]
    problem, _, _, _ = make_demo(demo, seed=0, device=dev, **sizes)
    args = demo_components(problem, temps * chains, rng, dev)
    nu = problem.nu
    n, nc = nu.shape[0], args[0].shape[1]
    g = f32(rng.normal(size=(temps * chains, n)))
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


REGIMES = ("windowed", "segment ms_global", "dense subgiant_mixed",
           "segment kepler_full", "segment reduced flagship")


def prepare(inp, precision="f32"):
    """Plan, outputs and scratch for one regime's inputs in `precision`;
    returns the (fwd, bwd) launch closures and the tensors they write."""
    nu, (H, Cc, W, B), win, g = inp["nu"], inp["args"], inp["win"], inp["g"]
    bt = H.shape[0]
    n = nu.shape[0]
    lo, hi = inp["ranges"]
    out = torch.empty((bt, n), dtype=torch.float32, device=nu.device)
    grads = tuple(torch.empty_like(H) for _ in range(4))
    plan = K.LorentzPlan(lo, hi, n, windowed=win is not None,
                         precision=precision)
    K._check(nu, (H, Cc, W, B), win, plan)
    f_args = K.fwd_args(plan, nu, H, Cc, W, B, win, out)
    plan_b = plan.for_walkers(bt)
    scratch = K.bwd_scratch(plan_b, bt, nu.device)
    b_args = K.bwd_args(plan_b, nu, g, H, Cc, W, B, win, scratch, grads)
    lib = K._lib()

    # the arguments are converted once, so a call costs the host little
    # more than the launch itself; the closures keep the plans' tensors
    def fwd(_keep=(plan, plan_b, scratch)):
        K._raise_on(lib.lorentz_fwd(*f_args), "lorentz_fwd")

    def bwd():
        K._raise_on(lib.lorentz_bwd(*b_args), "lorentz_bwd")
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
                           precision=precision)
        grads.append(torch.autograd.grad(out, part, inp["g"][lo:lo + step]))
        outs.append(out.detach())
    return torch.cat(outs), [torch.cat(p) for p in zip(*grads)]


def _wrapper(inp, precision):
    """(fwd, bwd) closures through the package's routed entry point: the
    forward without autograd, the backward of one retained graph."""
    extra = (inp["win"],) if inp["win"] is not None else ()
    leaves = [a.clone().requires_grad_(True) for a in inp["args"]]
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


def _check_against(label, out, grads, first, want_out, want_grads):
    """Errors of one instantiation against the plain version; raises past
    chip_smoke's tolerance or if two backward runs differ in any bit."""
    val_err = float((out - want_out).abs().max())
    val_ok = bool(((out - want_out).abs()
                   <= 1e-4 + 1e-4 * want_out.abs()).all())
    rel = max(float((x - y).abs().max() / (y.abs().max() + 1e-30))
              for x, y in zip(grads, want_grads))
    same = all(torch.equal(x, y) for x, y in zip(first, grads))
    if not (val_ok and rel <= 1e-4 and same):
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


def _sass(path, out_file):
    """Write cuobjdump -sass of `path` to `out_file`; return, per kernel,
    the opcode counts of each loop (a backward branch and its target) that
    holds at least two reciprocals or a tensor-core instruction:
    {kernel: [{"instructions": n, "ops": {...}}]}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out_file.write_text(text)
    loops = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"^\s+/\*([0-9a-f]{4,5})\*/\s+(?:@!?U?P\d+\s+)?(.*?);", func,
            re.M)]
        at = {addr: i for i, (addr, _) in enumerate(ins)}
        found = []
        for i, (addr, op) in enumerate(ins):
            m = re.match(r"BRA\S*\s+(?:\S+,\s+)?0x([0-9a-f]+)", op)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = ins[at[int(m.group(1), 16)]:i + 1]
            ops = collections.Counter(
                o.split()[0].split(".")[0] for _, o in body)
            if ops["MUFU"] >= 2 or ops["HMMA"]:
                found.append({"instructions": len(body),
                              "ops": dict(ops.most_common())})
        loops[_kernel_label(func.split("\n", 1)[0].strip())] = found
    return loops


def _max_cover(lo, hi, n):
    """Most components whose range holds one bin: the float32 terms the
    forward sums into a bin."""
    edges = np.zeros(n + 1, np.int64)
    keep = hi > lo
    np.add.at(edges, lo[keep], 1)
    np.add.at(edges, hi[keep], -1)
    return int(np.cumsum(edges)[:n].max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--regime", action="append", choices=REGIMES)
    ap.add_argument("--precision", choices=("f32", "bf16", "both"),
                    default="f32")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--sass", action="store_true")
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
    precisions = K.PRECISIONS if a.precision == "both" else (a.precision,)

    info = _cuda_build.build("lorentzian")
    print(f"build: {info['seconds']:.1f} s\n{info['log'].strip()}")
    result = {"device": smi, "reps": a.reps, "turns": a.turns,
              "precisions": list(precisions), "regimes": {},
              "rcp_mismatches": K.rcp_mismatches(dev)}
    print(f"reciprocal: {result['rcp_mismatches']} floats in [2^-126, 2^125]"
          " differ from the correctly rounded 1/y")
    if a.sass:
        loops = result["sass_loops"] = _sass(
            info["path"], out_path.with_suffix(".sass"))
        for kern, found in loops.items():
            for loop in found:
                print(f"sass {kern}: loop of {loop['instructions']} "
                      f"instructions {loop['ops']}")

    rng = np.random.default_rng(0)
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
        launch = {}
        for prec in precisions:
            if windowed and prec != "f32":
                continue
            want = _plain(inp, prec)
            fwd, bwd, out, grads = prepare(inp, prec)
            fwd()
            bwd()
            torch.cuda.synchronize()
            first = [t.clone() for t in grads]
            bwd()
            torch.cuda.synchronize()
            run = _check_against(f"{name} {prec}", out, grads, first, *want)
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
        del inp, launch
        torch.cuda.empty_cache()
    out_path.write_text(json.dumps(result, indent=1))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
