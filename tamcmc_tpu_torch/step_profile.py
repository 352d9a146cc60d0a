"""Per-layer time of one tempered MALA step of a demo or a problem file on a
GPU.

    python -m tamcmc_tpu_torch.step_profile [--demo ms_global | --problem
        FILE] [--temps T] [--chains 128] [--steps 100] [--reps 30]
        [--precision f32|f64] [--out chiprun_out/step_profile.json]

The problem is built by the CLI's own `cli._build_problem`, so a
FILE is read exactly as `run --problem FILE` reads it; it must name a
spectrum model of the MS_Global, RGB asymptotic or MS_local family.  T
defaults to the demo's or the file's own (6 for ms_global, 10 for
kepler_full, 8 for subgiant_mixed).  `--precision f64` profiles the step
of `run --precision f64`: the problem cast to float64 as `run` casts it,
its kernels the float64 instantiation.  Each piece of the step (assembly,
background, the forward kernel without the epilogue: segment mode for a
model with window segments, dense mode otherwise, the likelihood given the
modes, the log-likelihood forward and forward+backward as the step runs it
(the forward kernel with the chi22p epilogue and the backward kernel), the
same through the unfused chain (the model, then the likelihood; the on-card
reference) and with the background per walker, prior, the full step, the
swap sweep) is run on the same state, after warm-up, and timed twice:
  host_ms    synchronised wall time per call, averaged over `--reps` calls;
  device_ms  busy device time per call from torch.profiler: the union of
             the kernels', copies' and fills' intervals, over `--reps` calls;
  launches   device operations per call in that profile;
  span_ms    CUDA-event time per call on the stream over the same calls,
             idle gaps included (device_ms <= span_ms).
The whole step is also timed on the host over `--steps` steps, adaptive and
frozen, and in an interleaved A/B against the same step with the background
evaluated per walker; `peak_mib` is torch.cuda.max_memory_allocated over
one adaptive step and over one log-likelihood forward+backward, each from a
reset.  Every host timing runs before the first profiler session.  The idle
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

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")   # kineto activity types


def _host_ms(fn, reps, dev):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return 1e3 * (time.perf_counter() - t0) / reps


def _device_work(e):
    """A kernel, copy or fill on the card, not an annotation range."""
    if e.device_type() != DeviceType.CUDA:
        return False
    if hasattr(e, "activity_type"):         # newer torch
        return e.activity_type() in DEVICE_WORK
    return not getattr(e, "is_user_annotation", lambda: False)()


def _device_ms(fn, reps, dev):
    """(busy device ms per call, device operations per call, device span
    ms per call).  Busy time is the union of the intervals of the kernels,
    copies and fills in the profiler's raw event list; the span is CUDA
    events on the stream around all calls, idle gaps included, so busy <=
    span."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(dev)
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if _device_work(e))
    if not spans:
        raise RuntimeError("the profiler recorded no device work")
    busy_ns, end = 0, 0
    for lo, hi in spans:
        busy_ns += max(0, hi - max(lo, end))
        end = max(end, hi)
    return (busy_ns / 1e6 / reps, len(spans) / reps,
            start.elapsed_time(stop) / reps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--demo", help="built-in demo (default ms_global)")
    ap.add_argument("--problem", help="problem file, as `run --problem`")
    ap.add_argument("--temps", type=int,
                    help="temperatures (default: the demo's)")
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", choices=("f32", "f64"), default="f32",
                    help="f64: the step of `run --precision f64`")
    ap.add_argument("--out", default="chiprun_out/step_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile needs a CUDA device")

    from tamcmc_tpu_torch.cli import _build_problem
    from tamcmc_tpu_torch.models.common import fixed_noise
    from tamcmc_tpu_torch.ops.lorentzian import segment_values, sum_lorentzians
    from tamcmc_tpu_torch.sampler.driver import raw_step
    from tamcmc_tpu_torch.sampler.mala import init_state, mala_step
    from tamcmc_tpu_torch.sampler.tempering import (make_beta_ladder,
                                                    tempering_swap)
    from tamcmc_tpu_torch.stats.likelihoods import (likelihood_chi22p,
                                                    likelihood_chi22p_pieces)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    if not args.problem:
        args.demo = args.demo or "ms_global"
    elif args.demo:
        raise SystemExit("give --demo or --problem, not both")
    what = args.problem or args.demo
    problem, hp, _, meta = _build_problem(args, dev)
    if args.precision == "f64":
        problem = problem.astype(torch.float64)     # as `run` casts it
    args.temps = args.temps or meta["n_temps"]
    fn, layout = problem.model_fn, problem.layout
    if not hasattr(fn, "_assemble"):
        raise SystemExit(f"{what}: step_profile needs a spectrum model of "
                         "the MS_Global, RGB asymptotic or MS_local family")
    segments = getattr(fn, "_window_groups", None) is not None
    betas = make_beta_ladder(args.temps, hp.lambda_temp, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_state(problem, hp, args.temps, args.chains, gen)
    for _ in range(args.warmup):
        state = raw_step(problem, hp, betas, state, gen, True)

    x = state.u_center + state.u_scale * state.theta     # (T, C, Df)
    fixed = (problem.params0, ~problem.priors.free_mask)
    const = fixed_noise(layout, fixed)
    nu = problem.nu

    def per_walker_model(params, nu_, fixed=None):
        return fn(params, nu_)

    def unfused_model(params, nu_, fixed=None):
        return fn(params, nu_, fixed=fixed)

    # the model without the fused likelihood's hook, so the Problem takes
    # the model and then the likelihood: with the fixed terms once (the
    # unfused chain) and without the Problem's fixed mask (the per-walker
    # background)
    per_walker = dataclasses.replace(problem, model_fn=per_walker_model)
    unfused = dataclasses.replace(problem, model_fn=unfused_model)

    def modes_fn(H, C, W, B):
        if segments:
            return segment_values(nu, H, C, W, B, fn._window_groups,
                                  fn._plan)
        return sum_lorentzians(nu, H, C, W, B)

    def bg(c):
        return fn._background(nu, noise, c)

    def likelihood_given(modes):
        """The likelihood from the modes, background (fixed terms once)
        included."""
        if segments:
            return likelihood_chi22p_pieces(problem.spec, modes,
                                            lambda lo, hi: bg(const))
        return likelihood_chi22p(problem.spec, modes + bg(const))

    with torch.no_grad():
        full = problem.embed(x)
        H, C, W, B, noise = fn._assemble(full)
        modes = modes_fn(H, C, W, B)

    def logL_fwd_bwd(prob):
        def run():
            xl = x.detach().requires_grad_(True)
            logL = prob._logL_from_full(prob.embed(xl))
            torch.autograd.grad(logL.sum(), xl)
        return run

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
        (("segment pieces" if segments else "dense sum") + " (fwd kernel)",
         nograd(lambda: modes_fn(H, C, W, B))),
        ("chi22p given the modes", nograd(
            lambda: likelihood_given(modes))),
        ("logL fwd", nograd(lambda: problem._logL_from_full(
            problem.embed(x)))),
        ("logL fwd+bwd", logL_fwd_bwd(problem)),
        ("logL fwd, unfused chain", nograd(lambda: unfused._logL_from_full(
            unfused.embed(x)))),
        ("logL fwd+bwd, unfused chain", logL_fwd_bwd(unfused)),
        ("logL fwd+bwd, per-walker background", logL_fwd_bwd(per_walker)),
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
    peak = {}
    for key, f in (("mala_step adaptive",
                    dict(layers)["mala_step adaptive"]),
                   ("logL fwd+bwd", logL_fwd_bwd(problem)),
                   ("logL fwd+bwd, unfused chain", logL_fwd_bwd(unfused))):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        f()
        torch.cuda.synchronize(dev)
        peak[key] = torch.cuda.max_memory_allocated(dev) / 2**20
    for row, (_, f) in zip(rows, layers):
        row["device_ms"], row["launches"], row["span_ms"] = _device_ms(
            f, args.reps, dev)
    step_dev = next(r["device_ms"] for r in rows
                    if r["layer"] == "mala_step adaptive")

    print(f"{what} ({args.precision}): T={args.temps} C={args.chains} "
          f"N={nu.shape[0]}  [{smi}]")
    print(f"{'layer':40s} {'host ms':>9s} {'device ms':>10s} {'launches':>9s}"
          f" {'span ms':>9s}")
    for r in rows:
        print(f"{r['layer']:40s} {r['host_ms']:9.3f} {r['device_ms']:10.3f} "
              f"{r['launches']:9.1f} {r['span_ms']:9.3f}")
    print(f"step, host clock over {args.steps} steps: adaptive "
          f"{steps['adaptive']:.3f} ms, frozen {steps['frozen']:.3f} ms; "
          f"device idle share of the adaptive step "
          f"{1.0 - step_dev / steps['adaptive']:.3f}")
    print("peak device memory (MiB, from a reset): "
          + ", ".join(f"{k} {v:.1f}" for k, v in peak.items()))
    print("A/B of the background's form, adaptive ms/step in the order "
          "per-walker, fixed-once, fixed-once, per-walker: "
          f"{steps['ab_per_walker_bg'][0]:.3f}, "
          f"{steps['ab_fixed_once'][0]:.3f}, "
          f"{steps['ab_fixed_once'][1]:.3f}, "
          f"{steps['ab_per_walker_bg'][1]:.3f}")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "demo": args.demo,
        "problem": args.problem, "model": problem.model_meta["name"],
        "precision": args.precision, "temps": args.temps,
        "chains": args.chains, "n_bins": int(nu.shape[0]), "layers": rows,
        "step_host_ms": steps, "peak_mib": peak,
        "idle_share": 1.0 - step_dev / steps["adaptive"]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
