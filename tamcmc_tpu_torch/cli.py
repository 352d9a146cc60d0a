"""tamcmc_tpu_torch CLI: run / batch / export / stats / compare / evidence /
make-example / validate / model-eval / list-models (port of the same verbs
of tamcmc_tpu/cli.py, with their flags, output text and exit codes).

    python -m tamcmc_tpu_torch.cli run (--demo DEMO | --problem FILE)
        --outdir OUT [--device cuda] [--temps 6 --chains 128]
        [--burnin/--learning/--acquire N] [--thin K] [--chunk E] [--seed S]
        [--lambda-temp L] [--dn-mixing K] [--no-drift] [--target-acc A]
        [--adapt-ladder] [--resume] [--ckpt-every N] [--report-every N]
        [--no-report] [--max-rows N] [--debug] [--profile]
        [--precision f32|bf16|f64] [--ngrid N] [--n-orders K]
        [--mesh TxC [--runner gspmd|shardmap] [--distributed]]
    python -m tamcmc_tpu_torch.cli batch --presets TABLE [--config CFG]
        [--errors CFG] [--resume] [--precision f32|bf16] [--stacked]
        [--ckpt-every N] [--device cuda] [--no-report]
    python -m tamcmc_tpu_torch.cli export --outdir OUT [--phase A]
        [--thin K] [--range lo:hi] [--out FILE]
    python -m tamcmc_tpu_torch.cli stats --outdir OUT [--phase A]
        [--max-rows N] [--json FILE]
    python -m tamcmc_tpu_torch.cli compare A B [--phase A] [--z 3]
        [--std-ratio 1.5] [--json FILE]
    python -m tamcmc_tpu_torch.cli evidence --outdir OUT [--phase A]
        [--burn-frac F] [--json FILE]
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
blocks.  `run` writes betas.npy, metrics.jsonl, restore.npz (at every
phase's end, and every `--ckpt-every` chunks inside one), per phase
{phase}_samples.bin/.hdr and {phase}_chains.npz, and at the end
summary.json and, unless `--no-report`, the matplotlib report.  A killed
run continues with the same command plus `--resume` and leaves the .bin
files, the chains.npz arrays and betas.npy byte for byte as an
uninterrupted run would; the checkpoint records precision, runner, mesh,
device type, chunk, thin, adapt_ladder, temperatures and chains, and a
resume that differs in one of them exits with an error that names it.
`--mesh TxC` runs the fit over T x C processes (temperature shards x walker
shards, parallel/): without `--distributed` `run` starts them on this
machine itself; with it, a launcher (torchrun) did.  Rank 0 prints and
writes the run's files, each rank its shard of the cold rung's samples.
`--precision bf16` runs the Lorentzian profile stream in bfloat16 (the kernels' bf16
instantiation on a CUDA device); `--precision f64` runs the whole sampler in
float64, on a CUDA device through the kernels' float64 instantiation.  `batch` runs a
presets table of stars (TOML `[[star]]` rows or a provisional
config_presets.cfg, io/refconfig.py): one `run` per star into its outdir,
or with `--stacked` every star in one sampler whose step leads with a star
axis (sampler/ensemble.py), checkpointed to `stacked_restore.npz` beside the
table.  Every verb that
computes runs on `--device`, cuda unless the caller asks for the cpu;
`export`, `stats`, `compare`, `evidence` and `validate` only read files, on
the host.  `--ngrid` and `--n-orders` cut a demo to size and are refused
with `--problem`, whose grid and mode counts are the file's.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
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
    file's [sampler] values and a demo's.  A .cfg workflow's [MALA] block
    arrives as args.sampler_overrides (io/refconfig.py) and sits below the
    flags."""
    out = dict(getattr(args, "sampler_overrides", None) or {})
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


def _profile_precision(args) -> str:
    """The Lorentzian profile stream a run's models are built with: bf16
    under `--precision bf16`, else f32 (f64 casts the data, not the
    stream)."""
    return "bf16" if getattr(args, "precision", "f32") == "bf16" else "f32"


def _problem_from_file(args, device):
    """(problem, hp, plan, meta) of `--problem FILE`, everything on
    `device`, the models built in the run's profile precision."""
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
    precision = _profile_precision(args)
    fn, layout = build_model(cfg["model"], precision=precision,
                             **cfg["spec_kwargs"])
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
                                 precision=precision, **cfg["spec_kwargs"])

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
                                  "spec": getattr(fn, "_family_spec", None),
                                  "precision": precision})
    sampler_cfg = dict(cfg.get("sampler", {}))
    sampler_cfg.update(_sampler_cli_overrides(args))
    hp = _make_hyper(sampler_cfg)
    ph = dict(cfg.get("phases", {}))

    def arg(name, default):
        given = getattr(args, name, None)
        return ph.get(name, default) if given is None else given

    plan = PhasePlan(burnin=arg("burnin", 2000),
                     learning=arg("learning", 10000),
                     acquire=arg("acquire", 20000), thin=arg("thin", 10))
    return problem, hp, plan, {"n_temps": ph.get("temps") or 6,
                               "n_chains": ph.get("chains") or 4}


def _build_problem(args, device):
    """(problem, hp, plan, meta) of `--demo NAME` or `--problem FILE` on
    `device`; meta holds the demo's or the file's n_temps and n_chains.
    The command line's sampler and phase flags are applied to both."""
    if getattr(args, "demo", None):
        problem, hp, plan, meta = make_demo(
            args.demo, seed=args.seed, ngrid=getattr(args, "ngrid", None),
            n_orders=getattr(args, "n_orders", None), device=device,
            precision=_profile_precision(args))
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
    if getattr(args, "chunk", None) is not None:
        plan = dataclasses.replace(plan, chunk=args.chunk)
    return problem, hp, plan, meta


# What a checkpoint records about the run that wrote it and a resume must
# repeat, with what differs if it does not and the way out.
_PROVENANCE = {
    "precision": "likelihood precisions",
    "runner": "random-number protocols",
    "mesh": "process layouts (walker sums in another order)",
    "device": "random generators and arithmetic (a CPU and a CUDA generator "
              "are different algorithms)",
    "chunk": "checkpoint and ladder-update boundaries (the continuation "
             "would no longer be the interrupted run's)",
    "thin": "record spacings",
    "adapt_ladder": "temperature ladders",
    "n_temps": "ladder sizes",
    "n_chains": "walker counts",
    "n_stars": "star ensembles",
}
# fields no flag sets: the message names what sets them instead
_NOT_FLAGS = {"n_stars": "stars in the presets table"}
# fields a checkpoint of an earlier release lacks, and what it meant by them
# (every run before --mesh was a local one)
_ABSENT_MEANS = {"mesh": "none"}


def _check_resume_provenance(ckpt_path, **expect):
    """Refuse a --resume that differs from the run that wrote the
    checkpoint in a field of _PROVENANCE.  Reads only the npz's meta
    fields; touches no other file."""
    from tamcmc_tpu_torch.io.checkpoint import read_meta
    if not ckpt_path.exists():
        return
    meta = read_meta(str(ckpt_path))
    for field, current in expect.items():
        if field not in meta and field in _ABSENT_MEANS:
            meta[field] = _ABSENT_MEANS[field]
        if field not in meta:
            raise SystemExit(
                f"refusing to resume: checkpoint {ckpt_path} does not record "
                f"{field}; it was not written by this package's `run` or "
                "`batch`.  "
                "Start a fresh outdir.")
        written = str(meta[field])
        if written == str(current):
            continue
        if field in _NOT_FLAGS:
            raise SystemExit(
                f"refusing to resume: checkpoint {ckpt_path} was written "
                f"with {written} {_NOT_FLAGS[field]} but this run has "
                f"{current}; mixing the two would splice samples from "
                f"different {_PROVENANCE[field]} into one posterior.  "
                "Restore the table (or start a fresh outdir).")
        flag = {"n_temps": "temps", "n_chains": "chains"}.get(
            field, field).replace("_", "-")
        raise SystemExit(
            f"refusing to resume: checkpoint {ckpt_path} was written "
            f"under --{flag} {written} but this run requests --{flag} "
            f"{current}; mixing the two would splice samples from "
            f"different {_PROVENANCE[field]} into one posterior.  Re-run "
            f"with --{flag} {written} (or start a fresh outdir).")


def _model_at_median(problem, theta0):
    """The model spectrum at the median of (E, C, Df) cold-rung records, on
    the problem's device (the forward kernel at one walker on a CUDA
    device), as a host array."""
    med = torch.as_tensor(
        np.median(theta0.reshape(-1, theta0.shape[-1]), axis=0),
        dtype=problem.params0.dtype, device=problem.nu.device)
    with torch.no_grad():
        return problem.model_fn(problem.embed(med), problem.nu).cpu().numpy()


_PHASES = ("B", "L", "A")
_FRESH = ((), None, 0)     # a resume point: no phase done, none interrupted


def _resume_point(ckpt, device):
    """Load the checkpoint `ckpt`: (state, generator, its meta, resume
    point), the point being (the phases it finished, the phase it stopped
    inside or None, the records that phase had emitted)."""
    from tamcmc_tpu_torch.io.checkpoint import load_checkpoint
    state, gen, last, cmeta = load_checkpoint(str(ckpt), device)
    done = _PHASES[:_PHASES.index(last)]
    if int(cmeta.get("in_progress", 0)):
        emitted = int(cmeta["emitted"])
        print(f"resumed from {ckpt} mid-phase {last} ({emitted} records "
              "already emitted)")
        return state, gen, cmeta, (done, last, emitted)
    print(f"resumed from {ckpt} after phase {last}")
    return state, gen, cmeta, (done + (last,), None, 0)


def _whole(records, s):
    """A one-star run's records are its only star's."""
    return records


def _star_records(records, s):
    """Star s's records of a stacked run (leading emit axis, then stars)."""
    return {k: v[:, s] for k, v in records.items()}


def _run_phases(problem, hp, betas, state, gen, plan, writers, split,
                save_ckpt, ckpt_every, at=_FRESH, ladder=None, on_chunk=None,
                around=None, on_phase_end=None, mesh=None, runner=None,
                view=None):
    """B -> L -> A from the resume point `at`, for `run` (one writer,
    `split` = _whole) and `batch --stacked` (a writer a star, `split` =
    _star_records).

    Each chunk's records go to the writers, star s's through `split(records,
    s)`, then to `on_chunk(phase, records)`.  Every `ckpt_every` chunks the
    writers save their partial files and then `save_ckpt(state, rng_state,
    phase, extra)` writes a mid-phase checkpoint: the .bin holds at least
    what the checkpoint claims, and a resume cuts the files back to the
    checkpoint (`OutputWriter.resume_phase`).  A phase ends with its files,
    then its checkpoint, then the partial files gone: a kill between any two
    leaves a state that `--resume` continues from byte-equal (a finished
    phase's partial file that a kill left is removed on resume).  The steps of
    a phase run inside the context `around(phase)`; `on_phase_end(phase,
    n_steps, state, seconds)` follows each phase.  A mesh run (`mesh`,
    `runner`: one rank's part) passes `view`, which assembles the whole
    state from the ranks' blocks (a collective): checkpoints,
    `on_phase_end` and the printed acceptance see `view(state)`.  Returns
    (state, {phase: host records}, {phase: steps, seconds, cold-rung
    acceptance (a list of one a star for a stack), steps this leg ran})."""
    from tamcmc_tpu_torch.sampler.driver import run_phase
    view = view or (lambda s: s)
    done, mid_phase, mid_emitted = at
    device = problem.nu.device
    results, phases = {}, {}
    for name in done:
        for w in writers:
            w.discard_partial(name)
    for name, n_steps, adapt in plan.phases():
        if n_steps <= 0 or name in done:
            continue
        already = mid_emitted if name == mid_phase else 0
        if name == mid_phase:
            for w in writers:
                w.resume_phase(name, already * w.walkers_written)
        chunk_no = 0

        def chunk_done(o, _n=name):
            for s, w in enumerate(writers):
                w.append_chunk(_n, split(o, s))
            if on_chunk is not None:
                on_chunk(_n, o)

        def state_done(s, rng_state, emitted, _n=name):
            nonlocal chunk_no
            chunk_no += 1
            if ckpt_every and chunk_no % ckpt_every == 0:
                for w in writers:
                    w.save_partial(_n)
                save_ckpt(view(s), rng_state, _n,
                          {"in_progress": 1, "emitted": emitted})

        tp = time.perf_counter()
        try:
            with (around or (lambda _: contextlib.nullcontext()))(name):
                state, outs = run_phase(
                    problem, hp, betas, state, gen, n_steps, adapt=adapt,
                    thin=plan.thin, chunk=plan.chunk, on_chunk=chunk_done,
                    on_state=state_done, already_emitted=already,
                    ladder=ladder, mesh=mesh, runner_kind=runner)
        except BaseException:
            for w in writers:
                w.abort()          # no .hdr: the phase stays resumable
            raise
        for w in writers:
            w.finalize_phase(name, keep_partial=True)
        if outs:
            results[name] = outs
        whole = view(state)
        save_ckpt(whole, gen.get_state(), name)
        for w in writers:
            w.discard_partial(name)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - tp
        acc = whole.acc_rate.mean(dim=-1)[..., 0].tolist()  # walker mean
        phases[name] = {"steps": n_steps, "seconds": dt,
                        "cold_acceptance": acc,
                        # of this leg: fewer after a mid-phase resume
                        "steps_run": plan.thin * (outs["theta0"].shape[0]
                                                  if outs else 0)}
        print(f"phase {name}: {n_steps} steps in {dt:.1f}s "
              f"({n_steps / dt:.1f} it/s), cold acc="
              + ", ".join(f"{a:.3f}" for a in np.atleast_1d(acc)))
        if on_phase_end is not None:
            on_phase_end(name, n_steps, whole, dt)
    return state, results, phases


def _write_summaries(records, outdirs, names, split, max_rows):
    """Print the posterior summary of each star's records and write it to
    the star's summary.json."""
    from tamcmc_tpu_torch.diagnostics.summary import (format_summary,
                                                      posterior_summary)
    for s, (outdir, star_names) in enumerate(zip(outdirs, names)):
        rows = posterior_summary(split(records, s)["theta0"],
                                 names=star_names)
        if len(outdirs) > 1:
            print(f"--- star {s}: {outdir} ---")
        print(format_summary(rows, max_rows=max_rows))
        with open(pathlib.Path(outdir) / "summary.json", "w") as f:
            json.dump(rows, f, indent=1)


def _mesh_flags(args):
    """(n_temp_shards, n_chain_shards) or None, and the runner's name, from
    --mesh / --runner, with the refusals of the reference's `run`."""
    spec, runner = getattr(args, "mesh", None), getattr(args, "runner", None)
    if not spec:
        if runner:
            raise SystemExit("--runner selects the sharded execution and "
                             "requires --mesh TxC; without a mesh the local "
                             "runner executes")
        return None, "local"
    from tamcmc_tpu_torch.parallel.mesh import parse_mesh
    if getattr(args, "adapt_ladder", False):
        raise SystemExit("--adapt-ladder is local-runner only (drop --mesh)")
    shape = parse_mesh(spec)
    for given, n, what in ((args.temps, shape[0], "temps"),
                           (args.chains, shape[1], "chains")):
        if given is not None and given % n:
            raise SystemExit(f"mesh {shape[0]}x{shape[1]} must divide temps "
                             f"x chains; --{what} {given} is not a multiple "
                             f"of {n}")
    return shape, runner or "gspmd"


def cmd_run(args):
    """`run`: a local fit, or one rank of a mesh fit, or (`--mesh` without
    `--distributed`) the launcher of a mesh fit's ranks."""
    precision = getattr(args, "precision", "f32")
    shape, runner = _mesh_flags(args)
    mesh_label = f"{shape[0]}x{shape[1]}" if shape else "none"
    ckpt = pathlib.Path(args.outdir) / "restore.npz"
    if getattr(args, "resume", False):
        # before anything is built or written
        _check_resume_provenance(ckpt, precision=precision, runner=runner,
                                 mesh=mesh_label,
                                 device=torch.device(args.device).type)
    distributed = getattr(args, "distributed", False)
    if shape and shape[0] * shape[1] > 1 and not distributed:
        from tamcmc_tpu_torch.parallel.distributed import launch_local
        launch_local(args.argv, shape[0] * shape[1])
        return {"mesh": mesh_label, "processes": shape[0] * shape[1]}
    from tamcmc_tpu_torch.parallel import distributed as dist_
    # a rank leaves the group it joined: after its fit, behind rank 0 (the
    # host of a launcher's store); after an error, at once
    with dist_.joined(args.device) if distributed else \
            contextlib.nullcontext():
        return _run_rank(args, shape, runner, mesh_label, distributed)


def _run_rank(args, shape, runner, mesh_label, distributed):
    """cmd_run's fit in this process, a rank of a mesh run or alone."""
    from tamcmc_tpu_torch.parallel import distributed as dist_
    world = dist_.world_size()
    if shape is None and world > 1:
        raise SystemExit(f"--distributed with {world} processes needs --mesh "
                         f"TxC with T*C = {world}")
    if shape is not None and shape[0] * shape[1] != world:
        raise SystemExit(
            f"--mesh {mesh_label} needs {shape[0] * shape[1]} processes; "
            f"this run has {world}" + (
                " (--distributed found no launcher environment: "
                "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)"
                if distributed and world == 1 else ""))
    device = dist_.rank_device(args.device) if world > 1 else _device(args)
    if dist_.rank() == 0:
        return _run(args, device, shape, runner, mesh_label)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        return _run(args, device, shape, runner, mesh_label)


def _run(args, device, shape, runner, mesh_label):
    from tamcmc_tpu_torch.io.checkpoint import save_checkpoint
    from tamcmc_tpu_torch.io.outputs import OutputWriter
    from tamcmc_tpu_torch.parallel import distributed as dist_
    from tamcmc_tpu_torch.sampler.mala import init_state
    from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder
    from tamcmc_tpu_torch.utils.metrics import (COUNTERS, MetricsLogger,
                                                counters, counters_since,
                                                span, tracing)

    precision = getattr(args, "precision", "f32")
    outdir = pathlib.Path(args.outdir)
    ckpt = outdir / "restore.npz"
    resume = getattr(args, "resume", False)
    world, rank = dist_.world_size(), dist_.rank()
    lead = rank == 0               # prints and writes the run's own files
    debug = getattr(args, "debug", False)
    if debug:
        from tamcmc_tpu_torch.utils.debug import (chunk_finite_report,
                                                  enable_debug_mode)
        enable_debug_mode()
    report_every = getattr(args, "report_every", 0) or 0
    no_report = getattr(args, "no_report", False)
    if report_every or not no_report:
        # a run that cannot plot says so now, not after the Acquire phase
        from tamcmc_tpu_torch.diagnostics.report import (require_matplotlib,
                                                         write_report)
        require_matplotlib()

    problem, hp, plan, meta = _build_problem(args, device)
    if precision == "f64":
        # drawn in float32 first, so an f64 fit targets the f32 fit's data
        problem = problem.astype(torch.float64)
    n_temps = args.temps or meta["n_temps"]
    n_chains = args.chains or meta["n_chains"]
    provenance = {"precision": precision, "runner": runner,
                  "mesh": mesh_label, "device": device.type,
                  "chunk": plan.chunk, "thin": plan.thin,
                  "adapt_ladder": bool(hp.adapt_ladder),
                  "n_temps": n_temps, "n_chains": n_chains}
    if resume:
        _check_resume_provenance(ckpt, **provenance)
    mesh = None
    if shape:
        from tamcmc_tpu_torch.parallel.mesh import SamplerMesh
        from tamcmc_tpu_torch.parallel.sharded import (gather_state,
                                                       shard_state)
        if hp.adapt_ladder:
            raise SystemExit("adapt_ladder is local-runner only (drop "
                             "--mesh, or the problem file's adapt_ladder)")
        try:
            mesh = SamplerMesh(*shape, rank, n_temps, n_chains)
        except ValueError as e:
            raise SystemExit(str(e))

    outdir.mkdir(parents=True, exist_ok=True)
    betas = make_beta_ladder(n_temps, hp.lambda_temp, device=device)
    if lead:
        np.save(outdir / "betas.npy", betas.cpu().numpy())  # for `evidence`
    ladder = None
    if hp.adapt_ladder:
        # the dynamic ladder (sampler/ladder.py): tuned between the chunks
        # of the adapting phases, frozen in Acquire
        ladder = {"betas": betas.cpu().numpy().astype(np.float64),
                  "updates": 0, "last_att": np.zeros(n_temps),
                  "last_acc": np.zeros(n_temps)}

    at = _FRESH
    if resume and ckpt.exists():
        state, gen, cmeta, at = _resume_point(ckpt, device)
        if mesh is not None:
            state = shard_state(state, mesh)
        if ladder is not None:
            ladder.update(betas=np.asarray(cmeta["ladder_betas"]),
                          updates=int(cmeta["ladder_updates"]),
                          last_att=np.asarray(cmeta["ladder_last_att"]),
                          last_acc=np.asarray(cmeta["ladder_last_acc"]))
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        init_scales = None
        err_table = getattr(args, "init_scale_table", None)
        if err_table:
            # errors_default.cfg: per-parameter proposal seeds
            from tamcmc_tpu_torch.io.refconfig import scales_from_errors
            init_scales = scales_from_errors(problem, err_table)
        state = init_state(problem, hp, n_temps, n_chains, gen,
                           init_scales=init_scales,
                           block=mesh and (mesh.tsl, mesh.csl))

    metrics = MetricsLogger(str(outdir / "metrics.jsonl"), enabled=lead)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    metrics.log("run_start", n_temps=n_temps, n_chains=n_chains,
                ndim_free=problem.ndim_free, seed=args.seed, runner=runner,
                mesh=mesh_label, processes=world, backend=dist_.backend(),
                backend_rule=(f"nccl when device_count() >= world size, else "
                              f"gloo: {n_cards} card(s), {world} rank(s)"),
                precision=precision, device=device.type)
    if world > 1:
        print(f"mesh {mesh_label} ({runner} runner): {world} processes, "
              f"backend {dist_.backend()} ({n_cards} card(s) for {world} "
              "ranks)")
    shard = ({"walker_slice": dist_.process_local_slice(n_chains),
              "shard_tag": f"host{rank}"} if world > 1 else {})
    writer = OutputWriter(str(outdir), problem.free_names, n_temps, n_chains,
                          keep_chains=lead, **shard)
    ckpt_every = getattr(args, "ckpt_every", 0) or 0

    def save_ckpt(s, rng_state, phase, extra=None):
        if not lead:             # every rank gathered `s`; one writes it
            return
        meta_d = {**provenance, **(extra or {})}
        if ladder is not None:
            meta_d.update({f"ladder_{k}": v for k, v in ladder.items()})
        with span("checkpoint.save"):
            save_checkpoint(str(ckpt), s, rng_state, phase=phase,
                            meta=meta_d)

    # periodic in-run diagnostics: a rolling host buffer of recent chunks
    # feeds the report's artifact set into <outdir>/inrun/, refreshed in
    # place, so a killed fit still leaves current plots
    report_buf, report_chunks = [], 0
    REPORT_BUF_CAP = 100           # chunks kept for the traces

    def write_inrun_report(phase_name):
        stacked = {k: np.concatenate([c[k] for c in report_buf], axis=0)
                   for k in report_buf[0]}
        made = write_report(
            outdir / "inrun", {phase_name: stacked}, problem=problem,
            names=problem.free_names,
            model_at_median=_model_at_median(problem, stacked["theta0"]))
        metrics.log("inrun_report", phase=phase_name,
                    chunks_seen=report_chunks, artifacts=len(made))

    def on_chunk(name, o):
        nonlocal report_chunks
        if debug:
            bad = chunk_finite_report(o)
            if bad:
                metrics.log("debug_nonfinite", phase=name, **bad)
                print(f"[debug] non-finite values in chunk: {bad}")
        if report_every and lead:
            report_buf.append(o)
            del report_buf[:-REPORT_BUF_CAP]
            report_chunks += 1
            if report_chunks % report_every == 0:
                write_inrun_report(name)

    profiled = {}                  # phase -> its counters, under --profile

    @contextlib.contextmanager
    def around(name):
        report_buf.clear()         # traces must not span phase boundaries
        if not (getattr(args, "profile", False) and name == "A" and lead):
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof, tracing():
            before = counters()
            yield
            profiled[name] = counters_since(before)
        (outdir / "torch_trace").mkdir(exist_ok=True)
        prof.export_chrome_trace(str(outdir / "torch_trace" / "acquire.json"))

    def log_phase(name, n_steps, s, dt):
        acc_t = s.acc_rate.mean(dim=-1).cpu().numpy()    # walker mean
        swap = s.nswap_acc.cpu().numpy() / np.maximum(
            s.nswap_att.cpu().numpy(), 1)
        sigma = torch.exp(s.log_sigma).mean(dim=-1).cpu().numpy()
        metrics.log("phase_end", phase=name, steps=n_steps,
                    wall_s=round(dt, 2), steps_per_s=round(n_steps / dt, 1),
                    cold_acceptance=round(float(acc_t[0]), 4),
                    acceptance=[round(float(a), 4) for a in acc_t],
                    swap_rates=[round(float(s), 4) for s in swap[:-1]],
                    sigma=[round(float(s), 6) for s in sigma],
                    **({"counters": profiled.pop(name)}
                       if name in profiled else {}))

    t0 = time.perf_counter()
    state, results, phases = _run_phases(
        problem, hp, betas, state, gen, plan, [writer], _whole, save_ckpt,
        ckpt_every, at, ladder=ladder, on_chunk=on_chunk, around=around,
        on_phase_end=log_phase, mesh=mesh, runner=runner,
        view=(lambda s: gather_state(s, mesh)) if mesh else None)
    if world > 1:
        # each rank's device and kernel launches, on rank 0's metrics
        steps = sum(p["steps_run"] for p in phases.values())
        for r, info in enumerate(dist_.gather_objects(
                {"device": str(device),
                 "launches": dict(COUNTERS["launches"])})):
            metrics.log("rank_end", rank=r, steps=steps, **info)
    if ladder is not None:
        # `evidence` integrates the Acquire logL chains over the final
        # (frozen) ladder: overwrite the initial geometric one
        np.save(outdir / "betas.npy", np.asarray(ladder["betas"]))
        metrics.log("ladder_final",
                    betas=[round(float(b), 6) for b in ladder["betas"]],
                    updates=ladder["updates"])
    writer.close()
    metrics.close()

    phase = "A" if "A" in results else (list(results)[-1] if results else None)
    if phase and lead:
        if phase == at[1]:
            print(f"note: phase {phase} was resumed; the summary below "
                  "covers the records of this leg only (`stats --outdir "
                  f"{outdir}` reads the whole phase)")
        th = results[phase]["theta0"]
        _write_summaries(results[phase], [outdir], [problem.free_names],
                         _whole, getattr(args, "max_rows", 40))
        if not no_report:
            made = write_report(
                outdir, results, problem=problem, names=problem.free_names,
                model_at_median=_model_at_median(problem, th))
            print(f"report artifacts: {', '.join(made)}")
    print(f"total wall time {time.perf_counter() - t0:.1f}s; "
          f"outputs in {outdir}")
    return {"phases": phases, "n_temps": n_temps, "n_chains": n_chains,
            "thin": plan.thin, "chunk": plan.chunk, "mesh": mesh_label,
            "processes": world}


def _presets(args):
    """(stars, cfg_defaults, err_table) of `batch --presets`: the TOML
    `[[star]]` rows, or a provisional config_presets.cfg with its optional
    config_default.cfg master and errors_default.cfg proposal seeds."""
    cfg_defaults, err_table = {}, None
    if args.presets.endswith(".cfg"):
        from tamcmc_tpu_torch.io.refconfig import (
            read_config_default_provisional, read_config_presets_provisional,
            read_errors_default_provisional)
        try:
            stars = read_config_presets_provisional(args.presets)
            if args.config:
                cfg_defaults = read_config_default_provisional(args.config)
            if args.errors:
                err_table = read_errors_default_provisional(args.errors)
        except ValueError as e:
            raise SystemExit(str(e))
    else:
        import tomllib
        with open(args.presets, "rb") as f:
            stars = tomllib.load(f).get("star", [])
    if not stars:
        raise SystemExit(f"{args.presets}: no [[star]] entries")
    return stars, cfg_defaults, err_table


def _star_run_args(args, star, i, base, cfg_defaults, err_table):
    """The `run` arguments of preset row `star` (number i): its problem or
    demo, seed, phase counts and outdir, the table's defaults below the
    row's values, and the batch's device, precision, resume and report
    flags."""
    outdir = base / star.get("outdir", f"star_{i}")
    argv = ["run", "--outdir", str(outdir), "--device", args.device,
            "--seed", str(int(star.get("seed", 0))),
            "--precision", args.precision, "--ckpt-every",
            str(args.ckpt_every)]
    if star.get("demo"):
        argv += ["--demo", star["demo"]]
    if star.get("problem"):
        problem = pathlib.Path(star["problem"])
        argv += ["--problem", str(problem if problem.is_absolute()
                                  else base / problem)]
    given = {"temps": star.get("temps") or cfg_defaults.get("temps"),
             "chains": star.get("chains") or cfg_defaults.get("chains"),
             "thin": star.get("thin") or cfg_defaults.get("thin"),
             "burnin": star.get("burnin"), "learning": star.get("learning"),
             "acquire": star.get("acquire"), "chunk": star.get("chunk")}
    for flag, value in given.items():
        if value is not None:
            argv += [f"--{flag}", str(int(value))]
    if args.resume:
        argv.append("--resume")
    if args.no_report or star.get("no_report", False):
        argv.append("--no-report")
    ns = _parser().parse_args(argv)
    ns.sampler_overrides = cfg_defaults.get("sampler") or None
    ns.init_scale_table = err_table
    return ns


def cmd_batch(args):
    """Multi-star runs from a presets table, the reference's
    config_presets.cfg workflow.  Default: serial, one `run` after another
    into each row's outdir (`star_<i>` beside the table without one).
    --stacked: every star in one sampler (_batch_stacked)."""
    stars, cfg_defaults, err_table = _presets(args)
    base = pathlib.Path(args.presets).parent
    runs = [_star_run_args(args, star, i, base, cfg_defaults, err_table)
            for i, star in enumerate(stars)]
    if args.stacked:
        return _batch_stacked(args, runs, base)
    results = []
    for i, ns in enumerate(runs):
        print(f"=== star {i + 1}/{len(runs)}: {ns.problem or ns.demo} -> "
              f"{ns.outdir} ===")
        results.append(cmd_run(ns))
    return results


def _batch_stacked(args, runs, base):
    """The aligned-grid stacked ensemble: all stars in ONE sampler whose
    step leads with a star axis (sampler/ensemble.py), so on a CUDA device
    one step of S stars makes the kernel launches of one step of one star.

    Star 0's row sets the sampler, the phases, T, C and the seed.  Each
    star's records stream to its own OutputWriter chunk by chunk, and the
    stacked carry is checkpointed to `stacked_restore.npz` beside the table
    at every phase's end and every `--ckpt-every` chunks: `--resume`
    continues a killed ensemble with every star's files byte-equal to an
    uninterrupted run's, as `run --resume` does.  The checkpoint records
    run's fields (precision, runner, device type, chunk, thin, adapt_ladder,
    temperatures, chains) and the number of stars, and a resume that
    differs in one of them is refused."""
    from tamcmc_tpu_torch.io.checkpoint import save_checkpoint
    from tamcmc_tpu_torch.io.outputs import OutputWriter
    from tamcmc_tpu_torch.sampler.ensemble import (
        init_ensemble_state, stacked_problem, validate_stackable)
    from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder
    from tamcmc_tpu_torch.utils.metrics import span

    ckpt = base / "stacked_restore.npz"
    if args.resume:
        # before anything is built or written
        _check_resume_provenance(ckpt, precision=args.precision,
                                 runner="stacked",
                                 device=torch.device(args.device).type)
    device = _device(args)
    problems, outdirs = [], []
    for i, ns in enumerate(runs):
        problem, hp_i, plan_i, meta_i = _build_problem(ns, device)
        problems.append(problem)
        outdirs.append(pathlib.Path(ns.outdir))
        if i == 0:
            hp, plan, ns0 = hp_i, plan_i, ns
            n_temps = ns.temps or meta_i["n_temps"]
            n_chains = ns.chains or meta_i["n_chains"]
    try:
        validate_stackable(problems)
    except ValueError as e:
        raise SystemExit(
            f"batch --stacked: problems are not stackable ({e}); "
            "use the serial default for heterogeneous stars")
    if hp.adapt_ladder:
        raise SystemExit("batch --stacked runs the fixed geometric ladder; "
                         "drop adapt_ladder (or run the stars serially)")
    n_stars = len(problems)
    provenance = {"precision": args.precision, "runner": "stacked",
                  "device": device.type, "chunk": plan.chunk,
                  "thin": plan.thin, "adapt_ladder": False,
                  "n_temps": n_temps, "n_chains": n_chains,
                  "n_stars": n_stars}
    if args.resume:
        _check_resume_provenance(ckpt, **provenance)
    betas = make_beta_ladder(n_temps, hp.lambda_temp, device=device)
    stacked = stacked_problem(problems)

    at = _FRESH
    if args.resume and ckpt.exists():
        states, gen, _, at = _resume_point(ckpt, device)
    else:
        gen = torch.Generator(device=device).manual_seed(ns0.seed)
        init_scales = None
        if ns0.init_scale_table:
            from tamcmc_tpu_torch.io.refconfig import scales_from_errors
            init_scales = [scales_from_errors(p, ns0.init_scale_table)
                           for p in problems]
        states = init_ensemble_state(problems, hp, n_temps, n_chains, gen,
                                     init_scales=init_scales)

    for d in outdirs:
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "betas.npy", betas.cpu().numpy())     # for `evidence`
    writers = [OutputWriter(str(d), p.free_names, n_temps, n_chains)
               for d, p in zip(outdirs, problems)]

    def save_ckpt(s, rng_state, phase, extra=None):
        with span("checkpoint.save"):
            save_checkpoint(str(ckpt), s, rng_state, phase=phase,
                            meta={**provenance, **(extra or {})})

    print(f"stacked ensemble: {n_stars} stars x {n_temps} temps x "
          f"{n_chains} walkers, {problems[0].ndim_free} free dims")
    t0 = time.perf_counter()
    states, results, phases = _run_phases(
        stacked, hp, betas, states, gen, plan, writers, _star_records,
        save_ckpt, args.ckpt_every, at)
    for w in writers:
        w.close()
    print(f"ensemble done: {n_stars} stars in "
          f"{time.perf_counter() - t0:.1f}s")
    if "A" in results:
        _write_summaries(results["A"], outdirs,
                         [p.free_names for p in problems], _star_records, 12)
    print(f"stacked outputs in {n_stars} star directories")
    return {"phases": phases, "n_stars": n_stars, "n_temps": n_temps,
            "n_chains": n_chains, "thin": plan.thin, "chunk": plan.chunk}


def cmd_export(args):
    """Binary samples -> ASCII table (the reference's bin2txt)."""
    from tamcmc_tpu_torch.io.outputs import read_bin_samples
    # --thin/--range act on the EMIT (iteration) axis, not the flat
    # (emit x walker)-interleaved record stream: bin2txt thins the records
    # of one chain, and striding the interleaved array with a thin that is
    # not a multiple of Nchains would take an uneven walker subset per emit
    chains, names = read_bin_samples(args.outdir, args.phase,
                                     with_chains=True)   # (E, C, Df)
    chains = chains[::args.thin]
    if args.range:
        lo, hi = (int(x) for x in args.range.split(":"))
        chains = chains[lo:hi]
    samples = chains.reshape(-1, chains.shape[-1])
    out = args.out or f"{args.outdir}/{args.phase}_samples.txt"
    np.savetxt(out, samples, header=" ".join(names))
    print(f"wrote {samples.shape[0]} x {samples.shape[1]} samples "
          f"({chains.shape[0]} emits x {chains.shape[1]} walkers) to {out}")


def cmd_stats(args):
    from tamcmc_tpu_torch.diagnostics.summary import (format_summary,
                                                      posterior_summary)
    from tamcmc_tpu_torch.io.outputs import read_bin_samples
    samples, names = read_bin_samples(args.outdir, args.phase)
    rows = posterior_summary(samples, names=names)
    print(format_summary(rows, max_rows=args.max_rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


def cmd_evidence(args):
    """Thermodynamic-integration evidence from the tempered logL chains
    (diagnostics/evidence.py): the temperature ladder the fit already ran
    makes ln Z nearly free."""
    from tamcmc_tpu_torch.diagnostics.evidence import thermodynamic_evidence
    outdir = pathlib.Path(args.outdir)
    z = np.load(outdir / f"{args.phase}_chains.npz")
    if "logL" not in z.files:
        raise SystemExit(f"{args.phase}_chains.npz has no logL block")
    bpath = outdir / "betas.npy"
    if not bpath.exists():
        raise SystemExit(f"{bpath} missing (written by `tamcmc run`); "
                         "re-run the fit or supply an older outdir's ladder")
    res = thermodynamic_evidence(z["logL"], np.load(bpath),
                                 burn_frac=args.burn_frac)
    print(f"ln Z                = {res['logZ']:.4f}  "
          f"(+- {res['mc_err']:.4f} MC)")
    print(f"ln Z (sampled part) = {res['logZ_partial']:.4f}  "
          f"over beta in [{res['beta_min']:.5f}, 1]")
    print(f"prior-end slack     = {res['tail_slack']:.4f}  "
          f"(grow the ladder if this is not << the precision you need)")
    print("rung table (beta, E[lnL]):")
    for b, m in zip(res["betas_sorted"], res["mean_logL"]):
        print(f"  {b:9.5f}  {m:14.4f}")
    if args.json:
        out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in res.items()}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


def cmd_compare(args):
    """Posterior-moment parity check of two sample sets: two run outdirs,
    or an outdir against an ASCII table (`export`'s, or the reference's
    bin2txt), with ESS-aware z-scores; exit code 1 on inconsistency."""
    from tamcmc_tpu_torch.diagnostics.compare import (
        compare_posteriors, format_comparison, load_ascii_samples)
    from tamcmc_tpu_torch.io.outputs import read_bin_samples

    def load(src):
        if pathlib.Path(src).is_dir():
            # (E, C, D) per-walker chains: the ESS must see each walker's
            # own autocorrelated trajectory; the flat (E*C, D) interleave
            # overstates ESS by about tau and turns z-scores into false
            # INCONSISTENT verdicts
            return read_bin_samples(src, args.phase, with_chains=True)
        return load_ascii_samples(src)

    sa, na = load(args.a)
    sb, nb = load(args.b)
    res = compare_posteriors(sa, na, sb, nb, z_threshold=args.z,
                             std_ratio_threshold=args.std_ratio)
    print(format_comparison(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    if not res["consistent"]:
        raise SystemExit(1)


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


def _start_in_support(params0, priors):
    """`params0` with every row of a bounded prior moved into its support:
    Uniform into [lo, hi], Jeffreys into [knee, max] (its support starts at
    0, but half the proposals from a start on the edge leave it), the
    Uniform-Gaussian above its lower edge.  Returns (start, moved) with
    moved = [(name, from, to), ...]."""
    from tamcmc_tpu_torch.stats.priors import PriorKind
    start = np.array(params0, dtype=np.float64)
    names = priors.names or tuple(f"p{i}" for i in range(priors.ndim))
    moved = []
    for i, (kind, h) in enumerate(zip(priors.kinds, priors.hypers)):
        k, x = PriorKind(int(kind)), start[i]
        if k == PriorKind.UNIFORM:
            y = min(max(x, h[0]), h[1])
        elif k == PriorKind.JEFFREYS:
            y = x if 0.0 <= x <= h[1] else min(max(x, h[0]), h[1])
        elif k == PriorKind.UNIFORM_GAUSSIAN:
            y = max(x, h[0])
        else:
            continue
        if y != x:
            moved.append((names[i], float(x), float(y)))
            start[i] = y
    return start, moved


def cmd_make_example(args):
    """Export a built-in demo to the file-based workflow: spectrum data,
    problem.toml (and problem.model with --model-format) and the injected
    truth.  The demo's spectrum is the model on `--device` (the forward
    kernel on a CUDA device) times that device's noise draw, the data `run
    --demo` fits there with the same seed.  The frequency column is the
    demo's float64 grid, which reads back to the float32 grid the demo fits
    bit for bit and whose spacing is uniform to `validate`'s liking; the
    start point is the demo's with the rows that fell outside a bounded
    prior moved into its support (printed), so the file passes `validate`."""
    from tamcmc_tpu_torch.io.data import write_spectrum
    from tamcmc_tpu_torch.io.problemfile import write_problem_file

    problem, hp, plan, meta = make_demo(args.demo, seed=args.seed,
                                        ngrid=args.ngrid,
                                        device=_device(args))
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    data_name = "spectrum.npz" if args.npz else "spectrum.data"
    sigma = problem.sigma_spec
    write_spectrum(str(outdir / data_name), meta["nu64"],
                   problem.spec.cpu().numpy(),
                   sigma=None if sigma is None else sigma.cpu().numpy())

    defaults = MALAHyper()
    sampler = {f.name: getattr(hp, f.name) for f in dataclasses.fields(hp)
               if getattr(hp, f.name) != getattr(defaults, f.name)}
    phases = {"burnin": plan.burnin, "learning": plan.learning,
              "acquire": plan.acquire, "thin": plan.thin,
              "temps": meta["n_temps"], "chains": meta["n_chains"]}
    params0, moved = _start_in_support(problem.params0.cpu().numpy(),
                                       problem.priors)
    if moved:
        print("start point moved into its prior's support: " + ", ".join(
            f"{n} {a:.6g} -> {b:.6g} ({b - a:+.6g})" for n, a, b in moved))
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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tamcmc_tpu_torch",
        description="PyTorch/CUDA port of the tamcmc peak-bagging engine")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="execute a fit (B/L/A phases)")
    _add_problem_args(pr)
    _add_run_args(pr)
    pr.add_argument("--outdir", required=True)
    pr.add_argument("--resume", action="store_true",
                    help="continue from <outdir>/restore.npz with the same "
                         "flags on the same kind of device; the outputs end "
                         "byte for byte as an uninterrupted run's")
    pr.add_argument("--no-report", action="store_true",
                    help="skip the matplotlib report at the end of the run")
    pr.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler chrome trace of the "
                         "Acquire phase into <outdir>/torch_trace/")
    pr.add_argument("--debug", action="store_true",
                    help="debug mode: autograd anomaly detection + per-chunk "
                         "finite checks surfaced in metrics.jsonl")
    pr.add_argument("--adapt-ladder", action="store_true",
                    dest="adapt_ladder",
                    help="tune the per-rung temperatures toward uniform swap "
                         "acceptance between the chunks of Burn-in and "
                         "Learning (Vousden et al. 2016), frozen in Acquire; "
                         "the default ladder is fixed geometric")
    pr.add_argument("--chunk", type=int,
                    help="emitted records per device->host copy (default "
                         "200); smaller = finer checkpoint/report "
                         "granularity")
    pr.add_argument("--ckpt-every", type=int, dest="ckpt_every", default=0,
                    help="intra-phase checkpoint cadence in chunks (0 = "
                         "phase boundaries only); a killed run resumes "
                         "bitwise from the last chunk checkpoint.  One "
                         "checkpoint copies the whole state to the host "
                         "(cov, chol and ichol are T x C x Df x Df each): "
                         "12.4 MB in 0.02-0.03 s at ms_global (T=6, C=128, "
                         "Df=36), 129 MB in 0.19-0.25 s at kepler_full "
                         "(T=10, C=128, Df=91) on an NVIDIA H100 80GB HBM3 "
                         "at 700 W, against 21 and 28 ms a step: one every "
                         "1,000 steps or more (one chunk of 200 records at "
                         "thin 5) keeps it under 1 %% of the run")
    pr.add_argument("--report-every", type=int, dest="report_every",
                    default=0,
                    help="periodic in-run diagnostics cadence in chunks (0 = "
                         "end of run only): refreshes the artifact set "
                         "(spectrum + current-median model, traces, "
                         "acceptance) under <outdir>/inrun/, so a killed fit "
                         "still leaves plots; needs matplotlib")
    pr.add_argument("--precision", choices=("f32", "bf16", "f64"),
                    default="f32",
                    help="f32 (default): float32 throughout.  bf16: the "
                         "Lorentzian profile stream (1/(1+x^2) and its "
                         "products) in bfloat16 with float32 sums, x and "
                         "everything else float32: the kernels' bf16 "
                         "instantiation on a CUDA device, the plain torch "
                         "version on the cpu (the windowed sum stays "
                         "float32).  f64: the whole sampler in float64 (the "
                         "data stays the float32 draw, cast): the kernels' "
                         "float64 instantiation on a CUDA device, the plain "
                         "torch version on the cpu")
    pr.add_argument("--max-rows", type=int, default=40, dest="max_rows")
    pr.add_argument("--mesh",
                    help="run the fit over a TEMPSxCHAINS mesh of processes, "
                         "e.g. 2x1 (temperature shards x walker shards; the "
                         "mesh must divide --temps x --chains): swaps cross "
                         "processes on swap steps only, walker means are "
                         "summed across a row's processes every adapting "
                         "step.  Without --distributed this command starts "
                         "the T*C processes itself")
    pr.add_argument("--runner", choices=("gspmd", "shardmap"),
                    help="the reference's two names for the sharded runner, "
                         "kept so that its command lines run; here both run "
                         "the one torch.distributed runner "
                         "(parallel/shardmap_runner.py) and the name is "
                         "recorded in the checkpoint.  Needs --mesh; default "
                         "gspmd")
    pr.add_argument("--distributed", action="store_true",
                    help="a launcher (torchrun) started this process as one "
                         "rank: join its group from MASTER_ADDR, "
                         "MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK.  "
                         "Backend nccl when device_count() >= world size, "
                         "else gloo; rank r computes on cuda:{LOCAL_RANK %% "
                         "device_count} (or the cpu under --device cpu)")
    pr.set_defaults(fn=cmd_run)

    pb = sub.add_parser("batch", help="run a presets table of stars, "
                                      "serially or stacked (reference "
                                      "config_presets.cfg workflow)")
    pb.add_argument("--presets", required=True,
                    help="TOML with [[star]] entries: problem/demo, outdir, "
                         "optional overrides (seed, temps, chains, burnin, "
                         "learning, acquire, thin, chunk, no_report); a .cfg "
                         "path is read as a PROVISIONAL reference "
                         "config_presets table (io/refconfig.py)")
    pb.add_argument("--config",
                    help="provisional config_default.cfg: master sampler/"
                         "phase defaults applied below per-star overrides")
    pb.add_argument("--errors",
                    help="provisional errors_default.cfg: per-parameter "
                         "initial proposal sigmas")
    pb.add_argument("--resume", action="store_true",
                    help="continue each star's run (or the stacked "
                         "ensemble) from its checkpoint, as run --resume")
    pb.add_argument("--precision", choices=("f32", "bf16"), default="f32",
                    help="Lorentzian profile-stream arithmetic for every "
                         "star (see run --precision)")
    pb.add_argument("--stacked", action="store_true",
                    help="advance ALL stars in one sampler whose step leads "
                         "with a star axis (aligned grids and one model "
                         "family required): on a CUDA device the kernels "
                         "see S*T*C walkers, one step of S stars makes the "
                         "launches of one star's step")
    pb.add_argument("--ckpt-every", type=int, dest="ckpt_every", default=0,
                    help="intra-phase checkpoint cadence in chunks, of each "
                         "star's run or of the stacked ensemble (same "
                         "semantics as run --ckpt-every)")
    pb.add_argument("--device", default="cuda",
                    help="torch device of every star (default cuda; cpu "
                         "runs the plain torch versions of the kernels)")
    pb.add_argument("--no-report", action="store_true",
                    help="skip every star's matplotlib report (a TOML row's "
                         "no_report = true skips its own)")
    pb.set_defaults(fn=cmd_batch)

    pe = sub.add_parser("export", help="binary samples -> ASCII (bin2txt)")
    pe.add_argument("--outdir", required=True)
    pe.add_argument("--phase", default="A")
    pe.add_argument("--thin", type=int, default=1)
    pe.add_argument("--range", help="lo:hi record range")
    pe.add_argument("--out")
    pe.set_defaults(fn=cmd_export)

    ps = sub.add_parser("stats", help="posterior summary (quantiles, ESS)")
    ps.add_argument("--outdir", required=True)
    ps.add_argument("--phase", default="A")
    ps.add_argument("--max-rows", type=int, default=60, dest="max_rows")
    ps.add_argument("--json")
    ps.set_defaults(fn=cmd_stats)

    pv = sub.add_parser("evidence",
                        help="thermodynamic-integration ln Z from the "
                             "tempered logL chains (free with the ladder)")
    pv.add_argument("--outdir", required=True)
    pv.add_argument("--phase", default="A")
    pv.add_argument("--burn-frac", type=float, dest="burn_frac", default=0.0)
    pv.add_argument("--json")
    pv.set_defaults(fn=cmd_evidence)

    pq = sub.add_parser("compare",
                        help="posterior-moment parity check between two "
                             "sample sets (run outdirs or ASCII tables)")
    pq.add_argument("a", help="run outdir or ASCII sample table")
    pq.add_argument("b", help="run outdir or ASCII sample table")
    pq.add_argument("--phase", default="A")
    pq.add_argument("--z", type=float, default=3.0,
                    help="max |z| for per-param mean agreement")
    pq.add_argument("--std-ratio", type=float, default=1.5, dest="std_ratio",
                    help="allowed posterior-std ratio band [1/r, r]")
    pq.add_argument("--json")
    pq.set_defaults(fn=cmd_compare)

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
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    args.argv = argv          # what a mesh run's ranks run again
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
