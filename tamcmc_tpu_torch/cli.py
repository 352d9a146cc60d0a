"""tamcmc_tpu_torch CLI: the `run` verb (B/L/A phases) on a built-in demo.

    python -m tamcmc_tpu_torch.cli run --demo DEMO --outdir OUT \
        [--device cuda] [--temps 6 --chains 128] [--burnin/--learning/
        --acquire N] [--thin K] [--chunk E] [--seed S] [--ngrid N]
        [--n-orders K]

DEMO is one of single_lorentzian, harvey_background, ms_global, kepler_full,
subgiant_mixed and subgiant_mixed_inertia (BASELINE configs 1-5, see
demos.py).  Writes betas.npy and, per phase, {phase}_samples.bin/.hdr and
{phase}_chains.npz (readable by tamcmc_tpu's `read_bin_samples`/export).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import numpy as np
import torch

from tamcmc_tpu_torch.demos import DEMOS, make_demo


def cmd_run(args):
    from tamcmc_tpu_torch.io.outputs import OutputWriter
    from tamcmc_tpu_torch.sampler.driver import run_phase
    from tamcmc_tpu_torch.sampler.mala import init_state
    from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (use --device cpu)")
    problem, hp, plan, meta = make_demo(args.demo, seed=args.seed,
                                        ngrid=args.ngrid,
                                        n_orders=args.n_orders, device=device)
    n_temps = args.temps or meta["n_temps"]
    n_chains = args.chains or meta["n_chains"]
    for field in ("burnin", "learning", "acquire", "thin", "chunk"):
        if getattr(args, field) is not None:
            plan = dataclasses.replace(plan, **{field: getattr(args, field)})

    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    betas = make_beta_ladder(n_temps, hp.lambda_temp, device=device)
    np.save(outdir / "betas.npy", betas.cpu().numpy())
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_state(problem, hp, n_temps, n_chains, gen)
    writer = OutputWriter(str(outdir), problem.free_names, n_temps, n_chains)

    phases = {}
    t0 = time.perf_counter()
    for name, n_steps, adapt in plan.phases():
        if n_steps <= 0:
            continue
        tp = time.perf_counter()
        try:
            state, _ = run_phase(
                problem, hp, betas, state, gen, n_steps, adapt=adapt,
                thin=plan.thin, chunk=plan.chunk,
                on_chunk=lambda o, _n=name: writer.append_chunk(_n, o))
        except BaseException:
            writer.abort()
            raise
        writer.finalize_phase(name)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - tp
        acc = float(state.acc_rate[0].mean())
        phases[name] = {"steps": n_steps, "seconds": dt,
                        "cold_acceptance": acc}
        print(f"phase {name}: {n_steps} steps in {dt:.1f}s "
              f"({n_steps / dt:.1f} it/s), cold acc={acc:.3f}")
    writer.close()
    print(f"total wall time {time.perf_counter() - t0:.1f}s; "
          f"outputs in {outdir}")
    return {"phases": phases, "n_temps": n_temps, "n_chains": n_chains,
            "thin": plan.thin, "chunk": plan.chunk}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="tamcmc_tpu_torch",
        description="PyTorch/CUDA port of the tamcmc peak-bagging engine")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="execute a fit (B/L/A phases)")
    pr.add_argument("--demo", required=True, choices=sorted(DEMOS),
                    help="built-in demo (BASELINE configs 1-5)")
    pr.add_argument("--outdir", required=True)
    pr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "torch versions of the kernels)")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--ngrid", type=int, help="override the grid size")
    pr.add_argument("--n-orders", type=int, dest="n_orders",
                    help="override the radial-order count")
    pr.add_argument("--temps", type=int)
    pr.add_argument("--chains", type=int)
    pr.add_argument("--burnin", type=int)
    pr.add_argument("--learning", type=int)
    pr.add_argument("--acquire", type=int)
    pr.add_argument("--thin", type=int)
    pr.add_argument("--chunk", type=int,
                    help="emitted records per device->host copy (default 200)")
    pr.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
