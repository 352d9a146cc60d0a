"""The float32 sampler against double precision (the counterpart of
tools/validate_f64.py).

    python -m tamcmc_tpu_torch.validate_f64 [--device cuda]

The reference samples in float64; the port's contract is float32 with the
sampler in standardised u-space.  BASELINE configs 1-3 at CI scale
(validate_bf16.CONFIGS) are each fitted twice with validate_bf16's plan,
ladder, walkers and seed, both on `--device`: in float32 and in float64
(`Problem.astype(torch.float64)`, the `run --precision f64` path; on a
CUDA device the kernels' float64 instantiation), as the reference's tool
keeps both sides on one device.  Both fit ONE float32 data realisation:
the demo is drawn once on the CPU and both sides fit that spectrum on the
device (a demo draws its noise on its own device, so a CPU draw and a card
draw differ; the reference's first run read z_max 102 from two draws).
The pair is judged as validate_bf16 judges it; an inconsistency is to be
investigated, not thresholded away.

Prints one JSON line per config ({"config", "n_params", "z_max",
"inconsistent", "ok"}) and a verdict line, and exits 1 when a config is
inconsistent.
"""

from __future__ import annotations

import json
import sys

import torch

from tamcmc_tpu_torch.validate_bf16 import (CONFIGS, device_arg, fit, judge,
                                            with_data)


def problems(demo, kw, dev):
    """(float32 problem, float64 problem, hp), both on `dev`: one float32
    spectrum, drawn on the CPU, the float64 side its cast."""
    from tamcmc_tpu_torch.demos import make_demo
    cpu, hp, _, _ = make_demo(demo, seed=0, device="cpu", **kw)
    on_dev = cpu if dev.type == "cpu" else with_data(
        make_demo(demo, seed=0, device=dev, **kw)[0], cpu)
    return on_dev, on_dev.astype(torch.float64), hp


def main(argv=None):
    args = device_arg(__doc__.splitlines()[0]).parse_args(argv)
    from tamcmc_tpu_torch.cli import _device
    dev = _device(args)
    all_ok = True
    for demo, kw in CONFIGS:
        p32, p64, hp = problems(demo, kw, dev)
        line = judge(demo, fit(p32, hp), fit(p64, hp), extra=lambda r: {
            "z_max": max(abs(p["z"]) for p in r["params"])})
        all_ok &= line["ok"]
        print(json.dumps(line), flush=True)
    print(json.dumps({"verdict": "f32 posterior-consistent with f64"
                      if all_ok else "f32 FAILS f64 validation: investigate, "
                      "do not threshold away"}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
