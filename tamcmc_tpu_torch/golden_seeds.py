"""The reduced flagship's long fit at other sampler seeds, against the
reference's golden.

    python -m tamcmc_tpu_torch.golden_seeds --seeds 8 9 [--device cuda]
        [--precision f32] [--out chiprun_out/golden_seeds.jsonl]

The fit of `golden_flagship.run_fit`: the same problem file, plan, T and C;
only the sampler's generator seed changes (the data and the start are the
file's).  Each seed's Acquire moments are held against
tests/golden/flagship_posterior.json[precision] with
`golden_flagship.against`, and one JSON line per seed is printed (and
appended to `--out`): the device, the seed, max z, the parameters outside
the rule, and N0's row (z, std ratio, band) beside its mean and std.  It
separates chance from a fault in one parameter: a reading that stays off
at every seed, or differs between the card and the CPU, is not chance.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch


def one_seed(seed, precision, dev):
    """The JSON line of one sampler seed's fit."""
    from tamcmc_tpu_torch import golden_flagship as gf
    from tamcmc_tpu_torch.cli import _build_problem
    from tamcmc_tpu_torch.validate_bf16 import fit
    args = argparse.Namespace(demo=None, problem=str(gf.PROBLEM),
                              seed=gf.SEED, precision=precision)
    problem, hp, _, _ = _build_problem(args, dev)
    t0 = time.perf_counter()
    theta, names = fit(problem, hp, gf.PLAN, gf.T, gf.C, seed)
    seconds = time.perf_counter() - t0
    got = gf.moments(theta, names, gf.truth())
    ref = json.loads(gf.REFERENCE.read_text())[precision]
    bad, rows = gf.against(got, ref)
    j = got["names"].index("N0")
    n0 = next(r for r in rows if r[0] == "N0")
    return {"seed": seed, "precision": precision, "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "seconds": seconds, "max_z": max(r[1] for r in rows),
            "outside": bad, "ok": len(bad) <= 1,
            "N0": {"mean": got["mean"][j], "std": got["std"][j],
                   "ess": got["ess"][j], "z": n0[1], "std_ratio": n0[2],
                   "band": n0[3],
                   "ref_mean": ref["mean"][ref["names"].index("N0")]}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from tamcmc_tpu_torch.cli import _device
    dev = _device(args)
    for seed in args.seeds:
        line = json.dumps(one_seed(seed, args.precision, dev))
        print(line, flush=True)
        if args.out:
            out = pathlib.Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            with out.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
