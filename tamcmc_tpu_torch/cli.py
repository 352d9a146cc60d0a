"""tamcmc_tpu_torch CLI: run / make-example / validate / model-eval /
list-models (port of the same verbs of tamcmc_tpu/cli.py).

    python -m tamcmc_tpu_torch.cli run (--demo DEMO | --problem FILE)
        --outdir OUT [--device cuda] [--temps 6 --chains 128]
        [--burnin/--learning/--acquire N] [--thin K] [--chunk E] [--seed S]
        [--lambda-temp L] [--dn-mixing K] [--no-drift] [--target-acc A]
        [--ngrid N] [--n-orders K]
    python -m tamcmc_tpu_torch.cli make-example --demo DEMO --outdir DIR
        [--device cuda] [--seed S] [--ngrid N] [--npz] [--model-format]
    python -m tamcmc_tpu_torch.cli validate FILE [FILE ...]
    python -m tamcmc_tpu_torch.cli model-eval (--demo DEMO | --problem FILE)
        [--params VECTOR.txt] [--out model_eval.txt] [--device cuda]
        [--seed S] [--ngrid N] [--n-orders K]
    python -m tamcmc_tpu_torch.cli list-models

DEMO is one of demos.DEMOS (BASELINE configs 1-5 and ajfit).  FILE is a TOML
problem file (io/problemfile.py) or a provisional `.model` file
(io/reference.py): it names a model of the registry, a data file (relative
to FILE), a prior per parameter and the optional [sampler] and [phases]
blocks.  `run` writes betas.npy and, per phase, {phase}_samples.bin/.hdr
and {phase}_chains.npz (readable by tamcmc_tpu's `read_bin_samples`/export).
Every verb that computes runs on `--device`, cuda unless the caller asks
for the cpu.  `--ngrid` and `--n-orders` cut a demo to size and are refused
with `--problem`, whose grid and mode counts are the file's.
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
from tamcmc_tpu_torch.sampler.driver import PhasePlan
from tamcmc_tpu_torch.sampler.state import MALAHyper


def _make_hyper(overrides: dict) -> MALAHyper:
    """MALAHyper from a {field: value} dict, refusing unknown names loudly:
    a silently ignored sampler knob changes the posterior."""
    fields = {f.name for f in dataclasses.fields(MALAHyper)}
    bad = sorted(set(overrides) - fields)
    if bad:
        raise SystemExit(f"[sampler]: unknown MALAHyper field(s) {bad}; "
                         f"valid: {sorted(fields)}")
    return MALAHyper(**overrides)


def _sampler_cli_overrides(args) -> dict:
    """The sampler flags given on the command line; they override a problem
    file's [sampler] values and a demo's."""
    out = {}
    if getattr(args, "lambda_temp", None) is not None:
        out["lambda_temp"] = args.lambda_temp
    if getattr(args, "dn_mixing", None) is not None:
        out["dN_mixing"] = args.dn_mixing
    if getattr(args, "no_drift", False):
        out["use_drift"] = False
    if getattr(args, "target_acc", None) is not None:
        out["target_acceptance"] = args.target_acc
    if getattr(args, "adapt_ladder", False):
        out["adapt_ladder"] = True
    return out


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (use --device cpu)")
    return device


def _problem_from_file(args, device):
    """(problem, hp, plan, meta) of `--problem FILE`, everything on
    `device`."""
    from tamcmc_tpu_torch.io.data import read_spectrum
    from tamcmc_tpu_torch.models import build_model
    from tamcmc_tpu_torch.sampler.problem import Problem
    from tamcmc_tpu_torch.stats.assemblers import build_family_constraints
    from tamcmc_tpu_torch.stats.auto_priors import (AutoPriorError,
                                                    resolve_auto_priors)
    if args.problem.endswith(".model"):
        from tamcmc_tpu_torch.io.reference import read_model_provisional
        cfg = read_model_provisional(args.problem)
    else:
        from tamcmc_tpu_torch.io.problemfile import read_problem_file
        cfg = read_problem_file(args.problem)
    fn, layout = build_model(cfg["model"], **cfg["spec_kwargs"])
    data_path = cfg["data"]
    if not pathlib.Path(data_path).is_absolute():
        data_path = str(pathlib.Path(args.problem).parent / data_path)
    d = read_spectrum(data_path)
    if cfg.get("auto_window") and \
            cfg["model"].lower().startswith("model_ms_global"):
        # rebuild with static c*Gamma truncation windows anchored at params0
        # (the grid must be uniform; `validate` checks that)
        nu_np = np.asarray(d["nu"], dtype=np.float64)
        hint = (tuple(float(v) for v in cfg["params0"]), float(nu_np[0]),
                float(np.median(np.diff(nu_np))), int(nu_np.shape[0]),
                float(cfg.get("window_margin", 10.0)))
        fn, layout = build_model(cfg["model"], window_hint=hint,
                                 **cfg["spec_kwargs"])

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    mask = None
    if cfg["freq_range"]:
        lo, hi = cfg["freq_range"]
        mask = f32((d["nu"] >= lo) & (d["nu"] <= hi))
    sigma = (f32(d["sigma"])
             if "sigma" in d and cfg["likelihood"] == "chi_square" else None)
    extra = None
    if cfg.get("family_constraints", True):
        extra = build_family_constraints(cfg["model"], layout)
    # Auto prior rows get their hyperparameters here, from the float32 data
    # the fit sees, or the run refuses
    try:
        priors = resolve_auto_priors(
            cfg["priors"], cfg["params0"], layout=layout,
            nu=np.asarray(d["nu"], np.float32),
            spec=np.asarray(d["power"], np.float32))
    except AutoPriorError as e:
        raise SystemExit(f"{args.problem}: {e}")
    problem = Problem(model_fn=fn, layout=layout, priors=priors,
                      nu=f32(d["nu"]), spec=f32(d["power"]),
                      params0=f32(cfg["params0"]),
                      likelihood=cfg["likelihood"], sigma_spec=sigma,
                      mask=mask, extra_logp=extra,
                      model_meta={"name": cfg["model"],
                                  "spec": getattr(fn, "_family_spec", None)})
    sampler_cfg = dict(cfg.get("sampler", {}))
    sampler_cfg.update(_sampler_cli_overrides(args))
    hp = _make_hyper(sampler_cfg)
    ph = dict(cfg.get("phases", {}))

    def arg(name):
        return getattr(args, name, None)

    plan = PhasePlan(burnin=arg("burnin") or ph.get("burnin", 2000),
                     learning=arg("learning") or ph.get("learning", 10000),
                     acquire=arg("acquire") or ph.get("acquire", 20000),
                     thin=arg("thin") or ph.get("thin", 10))
    return problem, hp, plan, {"n_temps": ph.get("temps") or 6,
                               "n_chains": ph.get("chains") or 4}


def _build_problem(args, device):
    """(problem, hp, plan, meta) of `--demo NAME` or `--problem FILE` on
    `device`; meta holds the demo's or the file's n_temps and n_chains.
    The command line's sampler and phase flags are applied to both."""
    if getattr(args, "demo", None):
        problem, hp, plan, meta = make_demo(
            args.demo, seed=args.seed, ngrid=getattr(args, "ngrid", None),
            n_orders=getattr(args, "n_orders", None), device=device)
        cli = _sampler_cli_overrides(args)
        if cli:
            hp = dataclasses.replace(hp, **cli)
        for field in ("burnin", "learning", "acquire", "thin"):
            if getattr(args, field, None) is not None:
                plan = dataclasses.replace(
                    plan, **{field: getattr(args, field)})
    elif getattr(args, "problem", None):
        given = [flag for flag, name in (("--ngrid", "ngrid"),
                                         ("--n-orders", "n_orders"))
                 if getattr(args, name, None) is not None]
        if given:
            raise SystemExit(f"{' and '.join(given)}: only with --demo; a "
                             "problem file's grid and mode counts are its own")
        problem, hp, plan, meta = _problem_from_file(args, device)
    else:
        raise SystemExit("provide --demo NAME or --problem FILE")
    if hp.adapt_ladder:
        raise SystemExit("adapt_ladder: the dynamic temperature ladder is "
                         "not ported; run with the fixed geometric ladder "
                         "(remove adapt_ladder from [sampler] / drop "
                         "--adapt-ladder)")
    if getattr(args, "chunk", None) is not None:
        plan = dataclasses.replace(plan, chunk=args.chunk)
    return problem, hp, plan, meta


def cmd_run(args):
    from tamcmc_tpu_torch.io.outputs import OutputWriter
    from tamcmc_tpu_torch.sampler.driver import run_phase
    from tamcmc_tpu_torch.sampler.mala import init_state
    from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder

    device = _device(args)
    problem, hp, plan, meta = _build_problem(args, device)
    n_temps = args.temps or meta["n_temps"]
    n_chains = args.chains or meta["n_chains"]

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


def cmd_model_eval(args):
    """Parameter vector -> model spectrum file (the reference's getmodel):
    columns frequency, data, model.  `--params` holds a full (D) or a
    free-only (Df) vector; without it the problem's params0 is used.  On a
    CUDA device a spectrum model is the forward kernel at one walker."""
    device = _device(args)
    problem, _, _, _ = _build_problem(args, device)
    if args.params:
        params = torch.as_tensor(
            np.loadtxt(args.params).astype(np.float32), device=device)
        full = (problem.embed(params)
                if params.shape[0] == problem.ndim_free else params)
    else:
        full = problem.params0
    with torch.no_grad():
        model = problem.model_fn(full, problem.nu)
    out = args.out or "model_eval.txt"
    np.savetxt(out, np.column_stack([problem.nu.cpu().numpy(),
                                     problem.spec.cpu().numpy(),
                                     model.cpu().numpy()]),
               header="frequency_uHz data_power model_power")
    print(f"wrote model spectrum ({model.shape[0]} bins) to {out}")
    return out


def cmd_make_example(args):
    """Export a built-in demo to the file-based workflow: spectrum data,
    problem.toml (and problem.model with --model-format) and the injected
    truth.  The demo's spectrum is the model on `--device` (the forward
    kernel on a CUDA device) times that device's noise draw, the data `run
    --demo` fits there with the same seed."""
    from tamcmc_tpu_torch.io.data import write_spectrum
    from tamcmc_tpu_torch.io.problemfile import write_problem_file

    problem, hp, plan, meta = make_demo(args.demo, seed=args.seed,
                                        ngrid=args.ngrid,
                                        device=_device(args))
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    data_name = "spectrum.npz" if args.npz else "spectrum.data"
    sigma = problem.sigma_spec
    write_spectrum(str(outdir / data_name), problem.nu.cpu().numpy(),
                   problem.spec.cpu().numpy(),
                   sigma=None if sigma is None else sigma.cpu().numpy())

    defaults = MALAHyper()
    sampler = {f.name: getattr(hp, f.name) for f in dataclasses.fields(hp)
               if getattr(hp, f.name) != getattr(defaults, f.name)}
    phases = {"burnin": plan.burnin, "learning": plan.learning,
              "acquire": plan.acquire, "thin": plan.thin,
              "temps": meta["n_temps"], "chains": meta["n_chains"]}
    params0 = problem.params0.cpu().numpy()
    write_problem_file(str(outdir / "problem.toml"), meta["model"], params0,
                       problem.priors, likelihood=problem.likelihood,
                       data=data_name, spec_kwargs=meta.get("spec_kwargs"),
                       sampler=sampler, phases=phases)
    if args.model_format:
        from tamcmc_tpu_torch.io.reference import write_model_provisional
        write_model_provisional(str(outdir / "problem.model"), meta["model"],
                                params0, problem.priors,
                                likelihood=problem.likelihood, data=data_name,
                                spec_kwargs=meta.get("spec_kwargs"))
    np.savetxt(outdir / "truth.txt", np.asarray(meta["truth"]),
               header="injected parameter values (full ABI vector)")
    print(f"example '{args.demo}' written to {outdir}/ "
          f"(run: python -m tamcmc_tpu_torch.cli run --problem "
          f"{outdir / 'problem.toml'} --outdir {outdir / 'fit'})")


def cmd_validate(args):
    """Lint problem files before a fit (io/validate.py): every setup fault
    reported at once, on the host; exit code 1 if any file has an error."""
    from tamcmc_tpu_torch.io.validate import validate_problem
    any_err = False
    for path in args.files:
        errors, warns = validate_problem(path)
        status = "FAIL" if errors else ("WARN" if warns else "OK")
        print(f"{path}: {status}")
        for e in errors:
            print(f"  error: {e}")
        for w in warns:
            print(f"  warning: {w}")
        any_err = any_err or bool(errors)
    if any_err:
        raise SystemExit(1)


def cmd_list_models(args):
    from tamcmc_tpu_torch.models import list_models
    for m in list_models():
        print(m)


def _add_device_args(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "torch versions of the kernels)")
    p.add_argument("--seed", type=int, default=0)


def _add_problem_args(p):
    """Which problem, and where: `run` and `model-eval`."""
    p.add_argument("--demo", choices=sorted(DEMOS),
                   help="built-in demo (BASELINE configs 1-5, ajfit)")
    p.add_argument("--problem", help="TOML problem file or provisional "
                                     ".model file")
    _add_device_args(p)
    p.add_argument("--ngrid", type=int,
                   help="override a demo's grid size (--demo only)")
    p.add_argument("--n-orders", type=int, dest="n_orders",
                   help="override a demo's radial-order count (--demo only)")


def _add_run_args(p):
    """The ladder, the phases and the sampler's knobs: `run` only."""
    p.add_argument("--temps", type=int)
    p.add_argument("--chains", type=int)
    p.add_argument("--burnin", type=int)
    p.add_argument("--learning", type=int)
    p.add_argument("--acquire", type=int)
    p.add_argument("--thin", type=int)
    p.add_argument("--lambda-temp", type=float, dest="lambda_temp",
                   help="geometric temperature-ladder ratio T_k = lambda^k")
    p.add_argument("--dn-mixing", type=int, dest="dn_mixing",
                   help="tempering swap cadence (iterations)")
    p.add_argument("--no-drift", action="store_true",
                   help="disable the MALA drift (adaptive RW-Metropolis)")
    p.add_argument("--target-acc", type=float, dest="target_acc",
                   help="adaptation target acceptance rate")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="tamcmc_tpu_torch",
        description="PyTorch/CUDA port of the tamcmc peak-bagging engine")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="execute a fit (B/L/A phases)")
    _add_problem_args(pr)
    _add_run_args(pr)
    pr.add_argument("--outdir", required=True)
    pr.add_argument("--adapt-ladder", action="store_true",
                    dest="adapt_ladder",
                    help="the reference's dynamic temperature ladder: not "
                         "ported, the run exits with an error")
    pr.add_argument("--chunk", type=int,
                    help="emitted records per device->host copy (default 200)")
    pr.set_defaults(fn=cmd_run)

    pm = sub.add_parser("model-eval",
                        help="params -> model spectrum file (getmodel)")
    _add_problem_args(pm)
    pm.add_argument("--params", help="ASCII parameter vector file (full or "
                                     "free-only)")
    pm.add_argument("--out")
    pm.set_defaults(fn=cmd_model_eval)

    px = sub.add_parser("make-example",
                        help="export a built-in demo as problem.toml + "
                             "spectrum data")
    px.add_argument("--demo", required=True, choices=sorted(DEMOS))
    px.add_argument("--outdir", required=True)
    _add_device_args(px)
    px.add_argument("--ngrid", type=int,
                    help="override the demo's frequency-grid size")
    px.add_argument("--npz", action="store_true",
                    help="write spectrum.npz instead of ASCII .data")
    px.add_argument("--model-format", action="store_true",
                    dest="model_format",
                    help="also export problem.model in the provisional "
                         "reference setup format (io/reference.py)")
    px.set_defaults(fn=cmd_make_example)

    pc = sub.add_parser("validate",
                        help="lint problem files (priors, data, start point, "
                             "sampler/phase sections) before running")
    pc.add_argument("files", nargs="+", help="problem .toml / .model files")
    pc.set_defaults(fn=cmd_validate)

    pl = sub.add_parser("list-models", help="print the model registry")
    pl.set_defaults(fn=cmd_list_models)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
