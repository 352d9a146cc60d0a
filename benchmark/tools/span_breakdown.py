"""A cell's traced steps by the program's layers: the spans and the sync
counter of `tamcmc_tpu_torch.utils.metrics`, read by benchmark/spans.py,
beside the same steps traced with the program's tracing off.

    python benchmark/tools/span_breakdown.py --workload CELL --seed N
        [--pairs 3]

The cell's set-up as benchmark/harness.py makes it (stars, problem files,
build, state, adaptation or warm-up), one traced pass to warm the profiler,
then `pairs` pairs of traced passes of the cell's `trace_steps` frozen
steps under torch.profiler, tracing off and on in turns (the order flips
from pair to pair).  Prints one JSON line a pass: the traced host ms a step
and idle share, and with tracing on the layer numbers
(spans.layer_metrics), the device and idle seconds by layer, the synchronising
calls by span, the device operations that start before their launch (and
the earliest one's lead), and the unattributed share of busy time.
"""

import argparse
import json
import pathlib
import shutil
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]


def setup(cell, seed, dev):
    """(problem, hp, betas, state, generator) after the cell's set-up."""
    import torch
    from benchmark import harness, traffic
    from tamcmc_tpu_torch.sampler.driver import run_phase
    from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder
    tr, cfg = cell.traffic, cell.config
    stars = traffic.make_stars(cfg, tr["stars"], tr["catalogue_seed"], seed,
                               dev)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        paths = traffic.write_problems(cfg, stars, cfg["n_temps"],
                                       tr["chains"], tmp)
        problem, hp, temps, chains, problems = harness._build(
            paths, tr["precision"], dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    betas = make_beta_ladder(temps, hp.lambda_temp, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = harness._init(problem, problems, hp, temps, chains, gen)
    for n, adapt in ((tr["adapt_steps"], True), (tr["warmup_steps"], False)):
        if n:
            state, _ = run_phase(problem, hp, betas, state, gen, n,
                                 adapt=adapt, thin=tr["thin"],
                                 chunk=tr["chunk"])
    return problem, hp, betas, state, gen


def traced_pass(problem, hp, betas, state, gen, tr, dev, on):
    """The cell's trace_steps frozen steps under torch.profiler with the
    program's tracing `on` or off (harness.profiled); (state, line)."""
    from benchmark import spans
    from benchmark import trace as trace_mod
    from benchmark.harness import profiled
    n = tr["trace_steps"]
    state, whole, sp, moved = profiled(problem, hp, betas, state, gen, tr,
                                       dev, on)
    window_s = whole.window_s
    line = {"tracing": on, "steps": moved["steps"],
            "host_ms_per_step": 1e3 * window_s / n,
            "idle_share": (100.0 * (1.0 - whole.busy_s / window_s)
                           if whole.ops else None)}
    nonkernel = whole.select(lambda name: not name.startswith("lorentz_"))
    if nonkernel:
        line["nonkernel_device_ms"] = trace_mod.union_us(
            [(a, b) for a, b, _, _ in nonkernel]) / 1e3 / n
    if sp is not None:
        line.update(spans.layer_metrics(sp, moved["syncs"]))
        line.update(syncs=moved["syncs"], late_ops=sp.late,
                    late_lead_us=sp.lead_us)
        if sp.ops:
            line.update(
                device_by_span=trace_mod.top(sp.device_by_span()),
                idle_by_span=trace_mod.top(sp.idle_by_span()),
                unattributed_share=(100.0 * line["unattributed_device_ms"]
                                    * n * 1e3 / sp.busy_us))
            if nonkernel:
                parts = (line["assembly_device_ms"]
                         + line["sampler_device_ms"]
                         + line["unattributed_device_ms"])
                line["parts_over_nonkernel"] = (
                    parts / line["nonkernel_device_ms"])
    return state, line


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card here")
    cell = harness.load_cell(args.workload)
    for line in measure(cell, args.seed, args.pairs, torch.device("cuda")):
        print(json.dumps({"workload": args.workload, **line}), flush=True)


def measure(cell, seed, pairs, dev):
    """The lines of one warming pass (tracing on, not returned) and
    `pairs` pairs of passes, off and on in turns."""
    problem, hp, betas, state, gen = setup(cell, seed, dev)
    state, _ = traced_pass(problem, hp, betas, state, gen, cell.traffic,
                           dev, True)
    lines = []
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            state, line = traced_pass(problem, hp, betas, state, gen,
                                      cell.traffic, dev, on)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
