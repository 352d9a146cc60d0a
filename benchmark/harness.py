"""One run of one cell: set-up, the timed window, the traced steps, the
check of the answers, and the metrics.

Set-up: the cell's stars from the seed (traffic.py), their problem files
under the temporary directory, the program's problems built from them as
`run --problem` builds them (`cli._build_problem`), stacked through
`sampler.ensemble` when the cell has several stars, cast to float64 as
`run --precision f64` casts; the state initialised, adapted for the cell's
`adapt_steps` (which run every shape of the window's step), or else warmed
up by `warmup_steps` frozen steps in chunks of the window's shape.
The window drives `sampler.driver.run_phase` through frozen phases of
`thin * chunk` steps until `seconds` have passed, and ends in a
synchronise.  A traced run then profiles `trace_steps` more frozen steps
(the device trace, benchmark/trace.py), and as many again with the
program's tracing on (`utils.metrics.tracing`: its spans in the trace,
benchmark/spans.py, and the counters the steps moved): the per-layer
readers read both.

A configuration's family is a module of benchmark/reference, loaded by
name (`benchmark.reference.family`); readers are files of
benchmark/metrics, loaded by name.  A new configuration, cell or metric is
new files.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import importlib.util
import json
import pathlib
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import check, ess, spans, traffic, work
from benchmark import trace as trace_mod
from benchmark.reference import family

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """A workload entry of BENCHMARK.json with its traffic file and
    configuration, and the metrics it reports."""
    name: str
    traffic: dict
    config: dict
    end_to_end: list
    per_layer: list


def load_cell(name, root=ROOT):
    """The cell `name` of root/BENCHMARK.json: its workload file
    benchmark/workloads/<name>.json and its configuration's file, whose
    family's reference module has to exist."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic_ = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    if (traffic_["config"], traffic_["traffic"]) != (entry["config"],
                                                     entry["traffic"]):
        raise SystemExit(f"benchmark/workloads/{name}.json is not the "
                         "BENCHMARK.json entry's configuration and traffic")
    config = json.loads((root / conf["file"]).read_text())
    family(config["family"])

    def mine(metrics):
        return [m for m in metrics
                if name in m.get("workloads", [name])]
    return Cell(name, dict(traffic_, chips=entry["chips"]), config,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


@dataclasses.dataclass
class Run:
    """What a run leaves for the metric readers.  A traced run adds its
    `trace` (benchmark/trace.py), its program `spans` (benchmark/spans.py;
    None where the trace holds none) and the `counters` its traced steps
    moved (`utils.metrics.counters_since`)."""
    cell: Cell
    precision: str
    stars: int
    temps: int
    chains: int
    n_bins: int
    n_comp: int
    comp_bins: int
    setup_s: float
    problem_build_s: float
    window_s: float
    window_steps: int
    theta0: list
    trace: object = None
    spans: object = None
    counters: dict = None

    @property
    def walkers(self):
        return self.stars * self.temps * self.chains

    @functools.cached_property
    def ess(self):
        """Each star's cold-rung ESS over the window's theta0 records: the
        median over the free parameters."""
        th = np.concatenate(self.theta0, axis=0).astype(np.float64)
        if th.ndim == 3:                      # (E, C, F): one star
            th = th[:, None]
        return [float(np.median([ess.effective_sample_size(th[:, s, :, i])
                                 for i in range(th.shape[-1])]))
                for s in range(th.shape[1])]


def read_metric(name, run):
    """The metric's reader benchmark/metrics/<name>.py: read(run) -> value
    or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _build(paths, precision, device):
    """The program's problems, as `run --problem FILE --precision P`
    builds them; (problem, hp, n_temps, n_chains, per-star problems)."""
    from tamcmc_tpu_torch import cli
    problems = []
    for path in paths:
        args = cli._parser().parse_args(
            ["run", "--problem", str(path), "--outdir", str(path.parent),
             "--device", device.type, "--precision", precision])
        problem, hp, _, meta = cli._build_problem(args, device)
        problems.append(problem)
    if len(problems) > 1:
        if precision == "f64":
            raise SystemExit("a stack of stars runs in float32 or bf16")
        from tamcmc_tpu_torch.sampler.ensemble import (stacked_problem,
                                                       validate_stackable)
        validate_stackable(problems)
        problem = stacked_problem(problems)
    else:
        problem = problems[0]
        if precision == "f64":
            problem = problem.astype(torch.float64)
    return problem, hp, meta["n_temps"], meta["n_chains"], problems


def _init(problem, problems, hp, temps, chains, gen):
    if len(problems) > 1:
        from tamcmc_tpu_torch.sampler.ensemble import init_ensemble_state
        return init_ensemble_state(problems, hp, temps, chains, gen)
    from tamcmc_tpu_torch.sampler.mala import init_state
    return init_state(problem, hp, temps, chains, gen)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rows(state, idx):
    """The sampled walkers' answers on the host, (K, ...) rows."""
    f = state.theta.shape[-1]
    out = {"theta": state.theta.reshape(-1, f)[idx]}
    for k in ("logL", "logP"):
        out[k] = getattr(state, k).reshape(-1)[idx]
    for k in ("gradL", "gradP"):
        out[k] = getattr(state, k).reshape(-1, f)[idx]
    return {k: v.detach().cpu() for k, v in out.items()}


def run(cell, seed, seconds, traced, device, t_start, control=False,
        log=print):
    """One run of `cell` from the set-up on; returns the result line (a
    dict).  `control` runs the program in the cell's control precision
    instead of its own (benchmark/tools/readings.py)."""
    from tamcmc_tpu_torch.sampler.driver import run_phase
    from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder
    tr, cfg = cell.traffic, cell.config
    dev = torch.device(device)
    precision = tr["control"] if control else tr["precision"]
    n_stars = tr["stars"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stars = traffic.make_stars(cfg, n_stars, tr["catalogue_seed"], seed,
                                dev)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        paths = traffic.write_problems(cfg, stars, cfg["n_temps"],
                                       tr["chains"], tmp)
        t_b = time.perf_counter()
        problem, hp, temps, chains, problems = _build(paths, precision, dev)
        _sync(dev)
        build_s = time.perf_counter() - t_b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    betas = make_beta_ladder(temps, hp.lambda_temp, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = _init(problem, problems, hp, temps, chains, gen)
    thin, chunk = tr["thin"], tr["chunk"]
    if tr["adapt_steps"]:
        state, _ = run_phase(problem, hp, betas, state, gen,
                             tr["adapt_steps"], adapt=True, thin=thin,
                             chunk=chunk)
    if tr["warmup_steps"]:
        state, _ = run_phase(problem, hp, betas, state, gen,
                             tr["warmup_steps"], adapt=False, thin=thin,
                             chunk=chunk)
    idx = check.sample_walkers(seed, n_stars * temps * chains,
                               tr["check_walkers"])
    start_theta = _rows(state, idx)["theta"]
    _sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    log(f"set-up {setup_s:.1f} s (build {build_s:.2f} s); window")
    records, steps = [], 0
    while True:
        state, outs = run_phase(problem, hp, betas, state, gen, thin * chunk,
                                adapt=False, thin=thin, chunk=chunk)
        records.append(outs["theta0"])
        steps += thin * chunk
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    log(f"window {window_s:.2f} s, {steps} steps")
    trace = sp = moved = None
    if traced:
        # the device trace with the program's tracing off, as the readers
        # of the whole step have always read it; then the spans and the
        # counters, whose host work and sync warnings would move those
        state, trace, _, _ = profiled(problem, hp, betas, state, gen, tr,
                                      dev, on=False)
        state, _, sp, moved = profiled(problem, hp, betas, state, gen, tr,
                                       dev)
    answers = _rows(state, idx)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    fam = family(cfg["family"])
    del state, problem, problems
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    target = traffic.reference_target(cfg, stars, dev)
    cell_dtype = tr["precision"] if tr["precision"] == "f64" else "f32"
    uc = stars.p0[:, stars.free]
    us = traffic.u_scales(stars, cell_dtype)
    walkers_per_star = temps * chains
    values, per_walker = check.numbers(
        target, idx // walkers_per_star, answers, start_theta, uc, us,
        cell_dtype, tr["check_block"])
    correct, failed, checks = check.judge(values, per_walker, tr["limits"])
    comp_bins = (work.comp_bins(target.comp_lo.cpu(), target.comp_hi.cpu())
                 if target.comp_lo is not None
                 else fam.n_components(cfg) * cfg["n_bins"])
    result_run = Run(cell, precision, n_stars, temps, chains, cfg["n_bins"],
                     fam.n_components(cfg), comp_bins, setup_s, build_s,
                     window_s, steps, records, trace, sp, moved)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = read_metric(m["name"], result_run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": int(idx.shape[0]),
              "failed": failed, "metrics": metrics,
              "device": _device(dev, peak, trace)}
    if trace is not None:
        result["breakdown"] = {
            "device_ops": trace_mod.top({k: v[1] for k, v in
                                         trace.by_name().items()}),
            "idle_gaps": trace_mod.top(trace.idle_gaps())}
    result["numbers"] = values
    result["checks"] = checks
    return result


def profiled(problem, hp, betas, state, gen, tr, dev, on=True):
    """`trace_steps` frozen steps under torch.profiler, with the program's
    tracing `on` or off; (state, Trace, Spans or None (off, or no span in
    the trace), counters moved)."""
    from torch.profiler import ProfilerActivity, profile
    from tamcmc_tpu_torch.sampler.driver import run_phase
    from tamcmc_tpu_torch.utils.metrics import (counters, counters_since,
                                                tracing)
    n, thin = tr["trace_steps"], tr["thin"]
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof, tracing(on):
        before = counters()
        t0 = time.perf_counter()
        state, _ = run_phase(problem, hp, betas, state, gen, n, adapt=False,
                             thin=thin, chunk=n // thin)
        _sync(dev)
        window_s = time.perf_counter() - t0
        moved = counters_since(before)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bench-trace-"))
    try:
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        return (state, trace_mod.read_chrome_trace(path, n, window_s),
                spans.read(path, n) if on else None, moved)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _device(dev, peak, trace):
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python benchmark/run.py",
        description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)
