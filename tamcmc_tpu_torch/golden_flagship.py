"""Long-run golden posterior of the reduced flagship, made by the port
(the counterpart of tools/golden_flagship.py `generate`).

    python -m tamcmc_tpu_torch.golden_flagship generate
        [--out chiprun_out/flagship_posterior_torch.json] [--device cuda]

The reduced flagship is the reference's: demo ms_global at ngrid 6,000 and
4 orders, seed 0, T = 4, C = 16, read from tests/golden/flagship_reduced.toml
(the reference demo's spectrum as a problem file, as `run --problem` reads
it), and fitted with the reference's long plan (PLAN) and sampler seed 0 in
float32 and in bf16 on `--device`.  The JSON written to `--out` has the
reference golden's schema: provenance, then per precision the free
parameters' names, mean, std (ddof 1, float64 before the reductions), ESS
and truth (the demo's, from its numpy seed).  It never writes
tests/golden/flagship_posterior.json, which is the reference's.

Then each precision's moments are held against that reference golden with
the ESS-aware rule of tests/test_parity_harness.py (z < 4, the std ratio
inside exp(4 sqrt(1/(2 ESS_a) + 1/(2 ESS_b))), floored at 1.3; at most one
parameter outside): one JSON line per precision, and exit 1 if one fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

from tamcmc_tpu_torch.sampler.driver import PhasePlan

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROBLEM = ROOT / "tests" / "golden" / "flagship_reduced.toml"
REFERENCE = ROOT / "tests" / "golden" / "flagship_posterior.json"
DEMO_KW = {"ngrid": 6000, "n_orders": 4}
T, C, SEED = 4, 16, 0
PLAN = PhasePlan(burnin=500, learning=3000, acquire=24000, thin=4, chunk=500)


def run_fit(precision, dev, phase_plan=PLAN):
    """(theta (E, C, Df), free names) of the Acquire phase of the reduced
    flagship in `precision` on `dev`."""
    from tamcmc_tpu_torch.cli import _build_problem
    from tamcmc_tpu_torch.validate_bf16 import fit
    args = argparse.Namespace(demo=None, problem=str(PROBLEM), seed=SEED,
                              precision=precision)
    problem, hp, _, _ = _build_problem(args, dev)
    if problem._chi22p_hook is None:
        raise AssertionError("the fused likelihood must be engaged")
    return fit(problem, hp, phase_plan, T, C, SEED)


def moments(theta, names, truth):
    """The golden's entry of one precision."""
    from tamcmc_tpu_torch.diagnostics.ess import effective_sample_size
    th = np.asarray(theta, dtype=np.float64)
    flat = th.reshape(-1, th.shape[-1])
    return {"names": list(names), "mean": flat.mean(axis=0).tolist(),
            "std": flat.std(axis=0, ddof=1).tolist(),
            "ess": [effective_sample_size(th[:, :, i])
                    for i in range(th.shape[-1])],
            "truth": [float(v) for v in truth]}


def truth():
    """The demo's truth at its free parameters (numpy-seeded, no device
    draw)."""
    from tamcmc_tpu_torch.demos import make_demo
    problem, _, _, meta = make_demo("ms_global", seed=SEED, **DEMO_KW)
    return np.asarray(meta["truth"])[problem.priors.free_mask]


def against(got, ref):
    """The parameters of `ref`'s names that miss the reference's rule
    between two moment sets: (name, z, std ratio, band) each."""
    bad, rows = [], []
    for i, name in enumerate(ref["names"]):
        j = got["names"].index(name)
        ess_a, ess_b = max(got["ess"][j], 2.0), ref["ess"][i]
        z = abs(got["mean"][j] - ref["mean"][i]) / max(np.sqrt(
            got["std"][j] ** 2 / ess_a + ref["std"][i] ** 2 / ess_b), 1e-300)
        ratio = got["std"][j] / max(ref["std"][i], 1e-300)
        band = max(np.exp(4.0 * np.sqrt(1 / (2 * ess_a) + 1 / (2 * ess_b))),
                   1.3)
        row = (name, float(z), float(ratio), float(band))
        rows.append(row)
        if z >= 4.0 or not (1 / band < ratio < band):
            bad.append(row)
    return bad, rows


def generate(out, dev, phase_plan):
    """Both precisions' long fits; their moments written to `out`."""
    doc = {"provenance": {
        "demo": "ms_global", "demo_kw": DEMO_KW, "temps": T, "chains": C,
        "seed": SEED, "plan": dataclasses.asdict(phase_plan),
        "problem": str(PROBLEM.relative_to(ROOT)), "device": str(dev),
        "torch": torch.__version__,
        "note": ("the reduced flagship's long-run moments made by "
                 "tamcmc_tpu_torch.golden_flagship; moments and ESS in "
                 "float64")}}
    t = truth()
    for precision in ("f32", "bf16"):
        print(f"# {precision}: long run", file=sys.stderr, flush=True)
        doc[precision] = moments(*run_fit(precision, dev, phase_plan), t)
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1))
    print(f"# wrote {out}", file=sys.stderr, flush=True)
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="run the long fits, write --out")
    g.add_argument("--out", default="chiprun_out/flagship_posterior_torch"
                                    ".json")
    g.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from tamcmc_tpu_torch.cli import _device
    dev = _device(args)
    if pathlib.Path(args.out).resolve() == REFERENCE.resolve():
        raise SystemExit(f"--out {args.out}: that is the reference's "
                         "golden; write the port's elsewhere")
    doc = generate(args.out, dev, PLAN)
    ref = json.loads(REFERENCE.read_text())
    ok = True
    for precision in ("f32", "bf16"):
        bad, rows = against(doc[precision], ref[precision])
        ok &= len(bad) <= 1
        print(json.dumps({
            "precision": precision, "n_params": len(rows),
            "max_z": max(r[1] for r in rows),
            "std_ratio_range": [min(r[2] for r in rows),
                                max(r[2] for r in rows)],
            "outside": bad, "ok": len(bad) <= 1}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
