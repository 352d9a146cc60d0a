"""Per-layer time of one tempered MALA step of the ms_global demo on a GPU.

    python -m tamcmc_tpu_torch.step_profile [--temps 6] [--chains 128]
        [--steps 100] [--reps 30] [--out chiprun_out/step_profile.json]

Each piece of the step (assembly, background, segment kernels, piece-wise
likelihood, one backward, prior, the full step, the swap sweep) is run on
the same state, after warm-up, and timed twice:
  host_ms    synchronised wall time per call, averaged over `--reps` calls;
  device_ms  busy device time per call from torch.profiler (the sum of the
             kernels' and copies' device time), over `--reps` calls;
  launches   device operations per call in that profile.
The whole step is also timed on the host over `--steps` steps, adaptive and
frozen, and in an interleaved A/B against the same step with the background
evaluated per walker.  Every host timing runs before the first profiler
session.  The idle
share is 1 - (mala_step's busy device time) / (host time of an adaptive
step).  One JSON object goes to `--out`, and a table to standard output.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _host_ms(fn, reps, dev):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def _device_ms(fn, reps, dev):
    """(busy device ms per call, device operations per call)."""
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
    busy_us, ops = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            # device_time_total on current torch, cuda_time_total before it
            busy_us += getattr(e, "device_time_total", None) \
                or e.cuda_time_total
            ops += e.count
    return busy_us / 1e3 / reps, ops / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--temps", type=int, default=6)
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/step_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile needs a CUDA device")

    from tamcmc_tpu_torch.demos import make_demo
    from tamcmc_tpu_torch.ops.lorentzian import segment_values
    from tamcmc_tpu_torch.ops.noise import noise_background
    from tamcmc_tpu_torch.sampler.driver import raw_step
    from tamcmc_tpu_torch.sampler.mala import init_state, mala_step
    from tamcmc_tpu_torch.sampler.tempering import (make_beta_ladder,
                                                    tempering_swap)
    from tamcmc_tpu_torch.stats.likelihoods import likelihood_chi22p_pieces

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    problem, hp, _, _ = make_demo("ms_global", seed=args.seed, device=dev)
    fn, layout = problem.model_fn, problem.layout
    spec = problem.model_meta["spec"]
    betas = make_beta_ladder(args.temps, hp.lambda_temp, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_state(problem, hp, args.temps, args.chains, gen)
    for _ in range(args.warmup):
        state = raw_step(problem, hp, betas, state, gen, True)

    x = state.u_center + state.u_scale * state.theta     # (T, C, Df)
    fixed = (problem.params0, ~problem.priors.free_mask)
    const = tuple(layout.get(a, "noise") for a in fixed)
    nu = problem.nu
    with torch.no_grad():
        full = problem.embed(x)
        H, C, W, B, noise = fn._assemble(full)
        pieces = segment_values(nu, H, C, W, B, fn._window_groups, fn._plan)

    def bg(c):
        return noise_background(nu, noise, n_harvey=spec.n_harvey,
                                kind=spec.noise_kind, const=c)

    def logL_fwd_bwd():
        xl = x.detach().requires_grad_(True)
        logL = problem._logL_from_full(problem.embed(xl))
        torch.autograd.grad(logL.sum(), xl)

    def logL_fwd_bwd_per_walker_bg():
        """The same, with the background evaluated per walker (the hook
        without the Problem's fixed mask)."""
        xl = x.detach().requires_grad_(True)
        segs, bg_fn = fn._segments_and_bg(problem.embed(xl), nu)
        logL = likelihood_chi22p_pieces(problem.spec, segs, bg_fn)
        torch.autograd.grad(logL.sum(), xl)

    def logP_fwd_bwd():
        xp = x.detach().requires_grad_(True)
        torch.autograd.grad(problem._logP_from_full(problem.embed(xp)).sum(),
                            xp)

    def nograd(f):
        def run():
            with torch.no_grad():
                f()
        return run

    layers = [
        ("assembly fwd", nograd(lambda: fn._assemble(problem.embed(x)))),
        ("background, per walker", nograd(lambda: bg(None))),
        ("background, fixed terms once", nograd(lambda: bg(const))),
        ("segment pieces (fwd kernel)", nograd(lambda: segment_values(
            nu, H, C, W, B, fn._window_groups, fn._plan))),
        ("chi22p pieces given the pieces", nograd(
            lambda: likelihood_chi22p_pieces(problem.spec, pieces,
                                             lambda lo, hi: bg(const)))),
        ("logL fwd", nograd(lambda: problem._logL_from_full(
            problem.embed(x)))),
        ("logL fwd+bwd", logL_fwd_bwd),
        ("logL fwd+bwd, per-walker background", logL_fwd_bwd_per_walker_bg),
        ("logP fwd+bwd", logP_fwd_bwd),
        ("logparts_and_grad", lambda: problem.logparts_and_grad(x)),
        ("mala_step adaptive", lambda: mala_step(problem, hp, betas, state,
                                                 gen, adapt=True)),
        ("mala_step frozen", lambda: mala_step(problem, hp, betas, state,
                                               gen, adapt=False)),
        ("tempering_swap", lambda: tempering_swap(betas, state, 0, gen)),
    ]
    # every host-clock timing first: a profiler session slows the host's
    # launches for the rest of the process
    rows = []
    for name, f in layers:
        for _ in range(3):
            f()
        rows.append({"layer": name, "host_ms": _host_ms(f, args.reps, dev)})
    def per_walker_model(params, nu_):
        return fn(params, nu_)

    # the hook without the Problem's fixed mask: the per-walker background
    per_walker_model._segments_and_bg = \
        lambda params, nu_, fixed=None: fn._segments_and_bg(params, nu_)
    per_walker = dataclasses.replace(problem, model_fn=per_walker_model)

    def step_ms(prob, adapt):
        s = state
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            s = raw_step(prob, hp, betas, s, gen, adapt)
        torch.cuda.synchronize(dev)
        return 1e3 * (time.perf_counter() - t0) / args.steps

    steps = {"adaptive": step_ms(problem, True),
             "frozen": step_ms(problem, False)}
    # interleaved A/B of the background's form, adaptive steps
    steps["ab_per_walker_bg"], steps["ab_fixed_once"] = [], []
    for key in ("ab_per_walker_bg", "ab_fixed_once", "ab_fixed_once",
                "ab_per_walker_bg"):
        steps[key].append(step_ms(per_walker if "walker" in key else problem,
                                  True))
    for row, (_, f) in zip(rows, layers):
        row["device_ms"], row["launches"] = _device_ms(f, args.reps, dev)
    step_dev = next(r["device_ms"] for r in rows
                    if r["layer"] == "mala_step adaptive")

    print(f"T={args.temps} C={args.chains} N={nu.shape[0]}  [{smi}]")
    print(f"{'layer':40s} {'host ms':>9s} {'device ms':>10s} {'launches':>9s}")
    for r in rows:
        print(f"{r['layer']:40s} {r['host_ms']:9.3f} {r['device_ms']:10.3f} "
              f"{r['launches']:9.1f}")
    print(f"step, host clock over {args.steps} steps: adaptive "
          f"{steps['adaptive']:.3f} ms, frozen {steps['frozen']:.3f} ms; "
          f"device idle share of the adaptive step "
          f"{1.0 - step_dev / steps['adaptive']:.3f}")
    print("A/B of the background's form, adaptive ms/step in the order "
          "per-walker, fixed-once, fixed-once, per-walker: "
          f"{steps['ab_per_walker_bg'][0]:.3f}, "
          f"{steps['ab_fixed_once'][0]:.3f}, "
          f"{steps['ab_fixed_once'][1]:.3f}, "
          f"{steps['ab_per_walker_bg'][1]:.3f}")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "temps": args.temps,
        "chains": args.chains, "n_bins": int(nu.shape[0]), "layers": rows,
        "step_host_ms": steps,
        "idle_share": 1.0 - step_dev / steps["adaptive"]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
