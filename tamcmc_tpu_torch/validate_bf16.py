"""Posterior validation of the bf16 Lorentzian stream against float32
(the counterpart of tools/validate_bf16.py).

    python -m tamcmc_tpu_torch.validate_bf16 [--device cuda]

BASELINE configs 1-3 at CI scale (single_lorentzian, harvey_background,
ms_global with ngrid 6,000 and 4 orders) are each fitted twice on
`--device`, in float32 and with `--precision bf16`'s profile stream, with
the reference's plan (PLAN, T = 4, C = 8, sampler seed 5), and the two
Acquire posteriors of the cold rung are judged by
`diagnostics.compare.compare_posteriors(z_threshold=4.0)`: a config is
consistent when at most max(1, n // 20) of its n parameters are not.
Config 2 has no Lorentzians: a control.  The precision travels with each
problem's model, so both fits run in this process.  Both fit the float32
problem's spectrum: a demo built in bf16 draws its spectrum through its bf16
model, which would move the data by the model's rounding (the reference's
two subprocesses did so) and mix that into the comparison.

Prints one JSON line per config ({"config", "n_params", "inconsistent",
"ok"}) and a verdict line, and exits 1 when a config is inconsistent.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from tamcmc_tpu_torch.sampler.driver import PhasePlan

CONFIGS = [
    ("single_lorentzian", {}),                        # BASELINE config 1
    ("harvey_background", {}),                        # config 2 (control)
    ("ms_global", {"ngrid": 6000, "n_orders": 4}),    # config 3, CI scale
]
TEMPS, CHAINS, SEED = 4, 8, 5
PLAN = PhasePlan(burnin=300, learning=1200, acquire=2400, thin=4, chunk=300)


def with_data(problem, source):
    """`problem` fitting `source`'s spectrum (and its sigma, if any), moved
    to `problem`'s device; the grid and the start point must already be the
    same bit for bit."""
    dev = problem.nu.device
    for name in ("nu", "params0"):
        a, b = getattr(problem, name), getattr(source, name)
        if not torch.equal(a.cpu().to(b.dtype), b.cpu()):
            raise ValueError(f"the two problems differ in {name}")
    sigma = source.sigma_spec
    return dataclasses.replace(
        problem, spec=source.spec.to(dev, problem.spec.dtype),
        sigma_spec=None if sigma is None else sigma.to(dev,
                                                       problem.spec.dtype))


def fit(problem, hp, phase_plan=PLAN, temps=TEMPS, chains=CHAINS,
        seed=SEED):
    """The Acquire records of the cold rung, (E, C, Df) float64, and the
    free parameters' names, of a fit on the problem's device with one
    generator seeded with `seed`."""
    from tamcmc_tpu_torch.sampler.driver import run_phases
    from tamcmc_tpu_torch.sampler.mala import init_state
    from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder
    dev = problem.nu.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    betas = make_beta_ladder(temps, hp.lambda_temp, device=dev)
    state = init_state(problem, hp, temps, chains, gen)
    _, results = run_phases(problem, hp, betas, state, gen, phase_plan)
    return results["A"]["theta0"].astype("float64"), problem.free_names


def config_ok(n_params: int, n_bad: int) -> bool:
    """The reference's rule: at most max(1, n // 20) parameters
    inconsistent."""
    return n_bad <= max(1, n_params // 20)


def judge(config, a, b, extra=None):
    """The JSON line of one config from its two fits ((theta, names)
    each)."""
    from tamcmc_tpu_torch.diagnostics.compare import compare_posteriors
    res = compare_posteriors(a[0], a[1], b[0], b[1], z_threshold=4.0)
    bad = [r["name"] for r in res["params"] if not r["ok"]]
    line = {"config": config, "n_params": len(res["params"])}
    line.update(extra(res) if extra else {})
    line.update(inconsistent=bad, ok=config_ok(len(res["params"]), len(bad)))
    return line


def device_arg(description):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="where the float32 fits run (default cuda)")
    return ap


def main(argv=None):
    args = device_arg(__doc__.splitlines()[0]).parse_args(argv)
    from tamcmc_tpu_torch.cli import _device
    from tamcmc_tpu_torch.demos import make_demo
    dev = _device(args)
    all_ok = True
    for demo, kw in CONFIGS:
        p32, hp, _, _ = make_demo(demo, seed=0, device=dev, **kw)
        p16 = with_data(make_demo(demo, seed=0, device=dev,
                                  precision="bf16", **kw)[0], p32)
        line = judge(demo, fit(p32, hp), fit(p16, hp))
        all_ok &= line["ok"]
        print(json.dumps(line), flush=True)
    print(json.dumps({"verdict": "bf16 posterior-consistent with f32"
                      if all_ok else "bf16 FAILS posterior validation"}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
