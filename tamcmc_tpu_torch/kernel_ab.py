"""Time the Lorentzian kernels alone at the main path's shapes on one GPU.

    python -m tamcmc_tpu_torch.kernel_ab --out chiprun_out/kernel_ab.json
    python -m tamcmc_tpu_torch.kernel_ab --sass --regime "segment ms_global"

Regimes (the shapes `chip_smoke.py` and the demos' runs give the kernels):
windowed 16x11x12,288; segment ms_global 768x54x40,000; dense subgiant_mixed
1024x210x60,000; segment kepler_full 1280x224x120,000.  Each launch is
enqueued through ctypes on preallocated outputs and arguments converted
once, so a time is the kernel's alone, from CUDA events around `--reps`
launches after warm-up, taken `--turns` times per regime.  The kernels are
first held against the plain torch version of the same inputs (run in
16-walker slices), and each time stands beside its roofline bound
(`lorentzian_kernel.bound_ms`).  To compare two versions of the source, run
this module from a checkout of each inside one job on one card, in turns.

`--sass` writes `cuobjdump -sass` of the build beside the JSON and prints,
per kernel, the opcode counts of every loop that holds a reciprocal: the
instruction mix per component-bin is a loop's counts over the
component-bins it covers (16 in the forward's loops, 8 or 4 in the
backward's).  Every time carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
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
    """{nu, args (H, C, W, B), win or None, g, ranges (lo, hi), plain}."""
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
                    plain=lambda nu_, *a: L.sum_lorentzians_trunc(nu_, *a))
    demo, temps = {"segment ms_global": ("ms_global", 6),
                   "segment kepler_full": ("kepler_full", 10),
                   "dense subgiant_mixed": ("subgiant_mixed", 8)}[name]
    problem, _, _, _ = make_demo(demo, seed=0, device=dev)
    args = demo_components(problem, temps * C, rng, dev)
    nu = problem.nu
    n, nc = nu.shape[0], args[0].shape[1]
    g = f32(rng.normal(size=(temps * C, n)))
    if name.startswith("segment"):
        fn = problem.model_fn
        groups = fn._window_groups
        return dict(nu=nu, args=args, win=None, g=g,
                    ranges=(fn._plan.comp_lo, fn._plan.comp_hi),
                    plain=lambda nu_, *a: L.sum_lorentzians_segments_plain(
                        nu_, *a, groups))
    return dict(nu=nu, args=args, win=None, g=g,
                ranges=(np.zeros(nc), np.full(nc, n)),
                plain=lambda nu_, *a: L.sum_lorentzians_plain(nu_, *a))


REGIMES = ("windowed", "segment ms_global", "dense subgiant_mixed",
           "segment kepler_full")


def prepare(inp):
    """Plan, outputs and scratch for one regime's inputs; returns the
    (fwd, bwd) launch closures and the tensors they write."""
    nu, (H, Cc, W, B), win, g = inp["nu"], inp["args"], inp["win"], inp["g"]
    bt = H.shape[0]
    n = nu.shape[0]
    lo, hi = inp["ranges"]
    out = torch.empty((bt, n), dtype=torch.float32, device=nu.device)
    grads = tuple(torch.empty_like(H) for _ in range(4))
    plan = K.LorentzPlan(lo, hi, n, windowed=win is not None)
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


def _time_ms(fn, reps):
    for _ in range(1 + reps // 7):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _plain(inp, step=16):
    """Values and gradients of sum(g * out) from the plain version, run on
    `step`-walker slices of the inputs (walkers are independent)."""
    outs, grads = [], []
    extra = (inp["win"],) if inp["win"] is not None else ()
    for lo in range(0, inp["g"].shape[0], step):
        part = [a[lo:lo + step].clone().requires_grad_(True)
                for a in inp["args"]]
        out = inp["plain"](inp["nu"], *part,
                           *(w[lo:lo + step] for w in extra))
        grads.append(torch.autograd.grad(out, part, inp["g"][lo:lo + step]))
        outs.append(out.detach())
    return torch.cat(outs), [torch.cat(p) for p in zip(*grads)]


def _sass(path, out_dir):
    """Write cuobjdump -sass of `path`; return, per kernel, the opcode
    counts of each loop (a backward branch and its target) that holds at
    least two reciprocals: {kernel: [{"instructions": n, "ops": {...}}]}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    (out_dir / "lorentzian.sass").write_text(text)
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
            if ops["MUFU"] >= 2:
                found.append({"instructions": len(body),
                              "ops": dict(ops.most_common())})
        loops[func.split("\n", 1)[0].strip()] = found
    return loops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--regime", action="append", choices=REGIMES)
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

    print(f"build\n{_cuda_build.build('lorentzian')['log'].strip()}")
    result = {"device": smi, "reps": a.reps, "regimes": {},
              "rcp_mismatches": K.rcp_mismatches(dev)}
    print(f"reciprocal: {result['rcp_mismatches']} floats in [2^-126, 2^125]"
          " differ from the correctly rounded 1/y")
    if a.sass:
        result["sass_loops"] = _sass(_cuda_build.library_path("lorentzian"),
                                     out_path.parent)
        for kern, loops in result["sass_loops"].items():
            for loop in loops:
                print(f"sass {kern}: loop of {loop['instructions']} "
                      f"instructions {loop['ops']}")

    rng = np.random.default_rng(0)
    for name in a.regime or REGIMES:
        inp = regime_inputs(name, dev, rng)
        bt, nc = inp["args"][0].shape
        n = inp["nu"].shape[0]
        lo, hi = (np.asarray(r, np.int64) for r in inp["ranges"])
        comp_bins = int(np.maximum(hi - lo, 0).sum())
        want_out, want_grads = _plain(inp)
        fwd, bwd, out, grads = prepare(inp)
        fwd()
        bwd()
        torch.cuda.synchronize()
        first = [t.clone() for t in grads]
        bwd()
        torch.cuda.synchronize()
        val_err = float((out - want_out).abs().max())
        val_ok = bool(((out - want_out).abs()
                       <= 1e-4 + 1e-4 * want_out.abs()).all())
        rel = max(float((x - y).abs().max() / (y.abs().max() + 1e-30))
                  for x, y in zip(grads, want_grads))
        same = all(torch.equal(x, y) for x, y in zip(first, grads))
        if not (val_ok and rel <= 1e-4 and same):
            raise AssertionError(
                f"{name}: values max abs err {val_err}, grads max rel err "
                f"{rel}, repeatable {same}")
        reg = {"bt": bt, "nc": nc, "n": n, "comp_bins_per_walker": comp_bins,
               "max_abs_err": val_err, "grad_max_rel_err": rel,
               "bwd_bitwise_repeatable": same, "fwd_ms": [], "bwd_ms": []}
        for kind in ("fwd", "bwd"):
            reg[f"{kind}_bound_ms"], reg[f"{kind}_bound_by"] = K.bound_ms(
                kind, bt, nc, n, comp_bins, inp["win"] is not None)
        for _ in range(a.turns):
            reg["fwd_ms"].append(_time_ms(fwd, a.reps))
            reg["bwd_ms"].append(_time_ms(bwd, a.reps))
        print(f"{name} ({bt}x{nc}x{n}): fwd "
              f"{' '.join(f'{t:.4f}' for t in reg['fwd_ms'])} ms (bound "
              f"{reg['fwd_bound_ms']:.4f}), bwd "
              f"{' '.join(f'{t:.4f}' for t in reg['bwd_ms'])} ms (bound "
              f"{reg['bwd_bound_ms']:.4f}); err {val_err:.2e} / {rel:.2e}  "
              f"[{smi}]")
        result["regimes"][name] = reg
        del inp, fwd, bwd, out, grads, want_out, want_grads
        torch.cuda.empty_cache()
    out_path.write_text(json.dumps(result, indent=1))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
