"""The adapting steps a cell's set-up needs: one star stack adapted in
one process, its state set aside at each count of adapting steps, and a
frozen window run from each, reporting the cold rung's ESS per
walker-step.  The cell's adapt_steps is the fewest after which that stops
rising.

    python benchmark/tools/adapt_sweep.py --workload kepler_full.stack8
        --seed N --steps 250 500 1000 2000 [--seconds 30]
"""

import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from benchmark import ess, harness, traffic
    from tamcmc_tpu_torch.sampler.driver import run_phase
    from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    cell = harness.load_cell(args.workload)
    tr, cfg = cell.traffic, cell.config
    stars = traffic.make_stars(cfg, tr["stars"], tr["catalogue_seed"],
                               args.seed, dev)
    tmp = pathlib.Path(tempfile.mkdtemp())
    paths = traffic.write_problems(cfg, stars, cfg["n_temps"], tr["chains"],
                                   tmp)
    problem, hp, temps, chains, problems = harness._build(
        paths, tr["precision"], dev)
    shutil.rmtree(tmp)
    betas = make_beta_ladder(temps, hp.lambda_temp, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = harness._init(problem, problems, hp, temps, chains, gen)
    thin, chunk = tr["thin"], tr["chunk"]
    done = 0
    for n in sorted(args.steps):
        t0 = time.perf_counter()
        state, _ = run_phase(problem, hp, betas, state, gen, n - done,
                             adapt=True, thin=thin, chunk=chunk)
        torch.cuda.synchronize()
        adapt_s = time.perf_counter() - t0
        done = n
        frozen, records, steps = state, [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            frozen, outs = run_phase(problem, hp, betas, frozen, gen,
                                     thin * chunk, adapt=False, thin=thin,
                                     chunk=chunk)
            records.append(outs["theta0"])
            steps += thin * chunk
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        th = np.concatenate(records).astype(np.float64)
        per_star = [float(np.median([ess.effective_sample_size(
            th[:, s, :, i]) for i in range(th.shape[-1])]))
            for s in range(th.shape[1])]
        print(json.dumps({"adapt_steps": n, "adapt_s": adapt_s,
                          "window_s": window_s, "steps": steps,
                          "ess_per_star": per_star,
                          "ess_per_walker_step": sum(per_star) / (
                              steps * tr["stars"] * chains),
                          "ess_per_s": sum(per_star) / window_s}),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
