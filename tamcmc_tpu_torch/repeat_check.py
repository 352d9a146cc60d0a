"""Does a fit repeat bit for bit?  Two runs of the CLI with one seed, each
in its own process, compared file by file; bitwise resume rests on this.

    python -m tamcmc_tpu_torch.repeat_check [--demo ms_global ...]
        [--device cuda] [--temps T] [--chains 128] [--steps 200]
        [--out chiprun_out/repeat_check.json]

For each demo: `run --demo D --seed 0 --chunk 10 --ckpt-every 2 --no-report`
twice (STEPS steps per phase, thin 5), then every {B,L,A}_samples.bin byte
for byte and every array of every chains.npz.  Where they differ, the first
differing record is named, and one evaluation of the log-posterior and its
gradients at the demo's start is repeated in this process to show which of
logL, logP, gradL, gradP does not repeat (an op with floating-point atomics
in its backward shows in a gradient only).  Prints one line per demo and
one JSON object at the end; exit code 1 if any demo does not repeat.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np


def _bins(a: pathlib.Path, b: pathlib.Path, phase: str) -> list:
    """The sample files of `phase` in either directory: {phase}_samples.bin,
    or a multi-process run's shards {phase}_samples.hostK.bin."""
    found = {f.name for d in (a, b) for f in d.glob(f"{phase}_samples*.bin")}
    return sorted(found) or [f"{phase}_samples.bin"]


def same_outputs(a: pathlib.Path, b: pathlib.Path) -> list:
    """Names of the output files (or arrays in them) of run directories `a`
    and `b` that differ; betas.npy, each phase's .bin (or its shards) and
    every chains.npz array.  A file missing on either side counts as
    differing."""
    bad = []
    for name in ("betas.npy", *(n for p in "BLA" for n in _bins(a, b, p))):
        fa, fb = a / name, b / name
        if not (fa.exists() and fb.exists()) \
                or fa.read_bytes() != fb.read_bytes():
            bad.append(name)
    for p in "BLA":
        fa, fb = a / f"{p}_chains.npz", b / f"{p}_chains.npz"
        if not (fa.exists() and fb.exists()):
            bad.append(fa.name)
            continue
        za, zb = np.load(fa), np.load(fb)
        if set(za.files) != set(zb.files):
            bad.append(fa.name)
            continue
        bad += [f"{fa.name}:{k}" for k in za.files
                if za[k].tobytes() != zb[k].tobytes()]
    return bad


def first_difference(a: pathlib.Path, b: pathlib.Path):
    """(phase, emit index) of the first cold-rung record that differs."""
    from tamcmc_tpu_torch.io.outputs import read_bin_samples
    for p in "BLA":
        ra, rb = (read_bin_samples(str(d), p, with_chains=True)[0]
                  for d in (a, b))
        n = min(len(ra), len(rb))
        diff = np.nonzero((ra[:n] != rb[:n]).reshape(n, -1).any(axis=1))[0]
        if diff.size or len(ra) != len(rb):
            return p, int(diff[0]) if diff.size else n
    return None


def step_repeats(demo: str, device: str, temps: int, chains: int) -> dict:
    """One evaluation of logparts_and_grad at the demo's start (walkers
    jittered), three times; which outputs repeat bit for bit."""
    import torch
    from tamcmc_tpu_torch.demos import make_demo
    from tamcmc_tpu_torch.sampler.mala import init_state
    problem, hp, _, _ = make_demo(demo, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(problem, hp, temps, chains, gen,
                       jitter=0.3)
    x = state.u_center + state.u_scale * state.theta
    runs = []
    for _ in range(3):
        (logL, logP), (gL, gP) = problem.batched_logparts_and_grad(x)
        runs.append({"logL": logL, "logP": logP, "gradL": gL, "gradP": gP})
    return {k: all(torch.equal(runs[0][k], r[k]) for r in runs[1:])
            for k in runs[0]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--demo", nargs="+",
                    default=["ms_global", "kepler_full", "subgiant_mixed"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--temps", type=int)
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="further flags handed to `run` (e.g. --ngrid 2000)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for demo in args.demo:
            dirs, secs = [], []
            for i in range(2):
                out = pathlib.Path(tmp) / f"{demo}_{i}"
                cmd = [sys.executable, "-m", "tamcmc_tpu_torch.cli", "run",
                       "--demo", demo, "--device", args.device, "--seed", "0",
                       "--chains", str(args.chains),
                       *(["--temps", str(args.temps)] if args.temps else []),
                       "--burnin", str(args.steps), "--learning",
                       str(args.steps), "--acquire", str(args.steps),
                       "--thin", "5", "--chunk", "10", "--ckpt-every", "2",
                       "--no-report", "--outdir", str(out), *args.extra]
                t0 = time.perf_counter()
                subprocess.run(cmd, check=True, capture_output=True)
                secs.append(time.perf_counter() - t0)
                dirs.append(out)
            bad = same_outputs(*dirs)
            res = {"repeats": not bad, "differ": bad,
                   "process_seconds": secs}
            if bad:
                res["first_difference"] = first_difference(*dirs)
                res["evaluation_repeats"] = step_repeats(
                    demo, args.device, args.temps or 2, args.chains)
            results[demo] = res
            print(f"{demo}: " + ("two runs byte-equal" if not bad else
                                 f"runs differ in {bad[:4]}... first at "
                                 f"{res['first_difference']}; one evaluation "
                                 f"repeats: {res['evaluation_repeats']}"),
                  flush=True)
    text = json.dumps(results)
    print(text)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    return 0 if all(r["repeats"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
