"""A/B of the adaptive temperature ladder against the static geometric one.

    python -m tamcmc_tpu_torch.ab_ladder [--configs kepler_full subgiant_mixed]
        [--device cuda] [--ngrid N] [--n-orders N] [--plan 1000,4000,6000,5]
        [--chunk 100] [--chains 16] [--temps T]
        [--out ab_ladder.jsonl]

For each config the same problem, seed and Burn-in / Learning / Acquire
plan (`--plan b,l,a,thin`) run twice through `sampler.driver.run_phase`:
with the fixed geometric ladder, and with `adapt_ladder` (the ladder tuned
between the chunks of Burn-in and Learning toward uniform pair swap
acceptance, frozen in Acquire; sampler/ladder.py).  One chunk of Acquire
steps runs first outside the timing; then the timed Acquire phase.  Each
arm prints one JSON line: the cold rung's median effective sample size
over the free parameters (diagnostics/ess.py, across walkers) and that
median per second of the timed phase, the Acquire steps, the pair swap
rates of the timed phase and their spread (standard deviation), the final
ladder, and the card's name and power limit (null on the CPU).  Configs
take the reference's temperatures (kepler_full 10, subgiant_mixed 8) and
16 walkers unless `--temps` / `--chains` say otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import torch

TEMPS = {"kepler_full": 10, "subgiant_mixed": 8}
SEED = 3          # the sampler's generator, both arms (the reference's key)


def fit(demo, demo_kw, plan, temps, chains, adaptive, device, chunk):
    """One arm: B and L adapting, one untimed Acquire chunk, the timed
    Acquire phase.  Returns the arm's measurements."""
    from tamcmc_tpu_torch.demos import make_demo
    from tamcmc_tpu_torch.diagnostics.ess import effective_sample_size
    from tamcmc_tpu_torch.sampler.driver import run_phase
    from tamcmc_tpu_torch.sampler.mala import init_state
    from tamcmc_tpu_torch.sampler.tempering import make_beta_ladder

    problem, hp, _, _ = make_demo(demo, seed=0, device=device, **demo_kw)
    hp = dataclasses.replace(hp, adapt_ladder=adaptive)
    betas = make_beta_ladder(temps, hp.lambda_temp, device=device)
    ladder = None
    if adaptive:
        ladder = {"betas": betas.cpu().numpy().astype(np.float64),
                  "updates": 0, "last_att": np.zeros(temps),
                  "last_acc": np.zeros(temps)}
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = init_state(problem, hp, temps, chains, gen)
    b, l, a, thin = plan

    def phase(steps, adapt):
        return run_phase(problem, hp, betas, state, gen, steps, adapt=adapt,
                         thin=thin, chunk=chunk, ladder=ladder)

    for steps in (b, l):
        state, _ = phase(steps, True)
    state, _ = phase(chunk * thin, False)          # warm-up, not timed
    att0 = state.nswap_att.cpu().numpy().copy()
    acc0 = state.nswap_acc.cpu().numpy().copy()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state, outs = phase(a, False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    th = outs["theta0"]                            # (E, C, Df)
    ess = np.asarray([effective_sample_size(th[:, :, i])
                      for i in range(th.shape[-1])])
    att = state.nswap_att.cpu().numpy() - att0
    acc = state.nswap_acc.cpu().numpy() - acc0
    rates = acc[:-1] / np.maximum(att[:-1], 1)
    return {"ess_per_s": float(np.median(ess)) / dt,
            "ess_median": float(np.median(ess)),
            "acquire_s": dt, "acquire_steps": th.shape[0] * thin,
            "ms_per_step": 1e3 * dt / (th.shape[0] * thin),
            "swap_rates": rates.tolist(),
            "swap_spread": float(rates.std()),
            "final_betas": (betas.cpu().numpy() if ladder is None
                            else ladder["betas"]).tolist()}


def main(argv=None):
    from tamcmc_tpu_torch.scale_procs import card_label
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=list(TEMPS),
                    choices=list(TEMPS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ngrid", type=int)
    ap.add_argument("--n-orders", type=int)
    ap.add_argument("--plan", default="1000,4000,6000,5",
                    help="burn-in, learning, acquire steps and thin")
    ap.add_argument("--chunk", type=int, default=100,
                    help="records a chunk (the ladder adapts between chunks)")
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--temps", type=int,
                    help="temperatures of every config (default: 10 for "
                         "kepler_full, 8 for subgiant_mixed)")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)
    plan = tuple(int(x) for x in args.plan.split(","))
    if len(plan) != 4:
        raise SystemExit("--plan takes burn-in,learning,acquire,thin")
    device = torch.device(args.device)
    demo_kw = {k: v for k, v in (("ngrid", args.ngrid),
                                 ("n_orders", args.n_orders)) if v}
    card = card_label(args.device)
    lines = []
    for demo in args.configs:
        temps = args.temps or TEMPS[demo]
        for arm in ("static", "adaptive"):
            r = fit(demo, demo_kw, plan, temps, args.chains,
                    arm == "adaptive", device, args.chunk)
            line = {"tool": "ab_ladder", "config": demo, "T": temps,
                    "C": args.chains, "arm": arm, "plan": list(plan),
                    **demo_kw, **r, "card": card}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(
            "".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
