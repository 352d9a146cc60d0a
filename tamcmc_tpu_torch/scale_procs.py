"""What a mesh costs against the local run of the same plan.

    python -m tamcmc_tpu_torch.scale_procs [--demo ms_global] [--device cuda]
        [--temps T] [--chains 128] [--steps 200] [--thin 5] [--chunk 10]
        [--ckpt-every 2] [--procs 1 2 [4]] [--repeats 2]
        [--ngrid N --n-orders N] [--out scale_procs.jsonl]

Each measurement is one `python -m tamcmc_tpu_torch.cli run` in a process
of its own: the local run (1 process) and, for each process count n of
`--procs` above 1, `--mesh nx1` (temperatures split) and `--mesh 1xn`
(walkers split), every one with the same demo, seed, steps, `--chunk` and
`--ckpt-every`.  The metric is ms/step of the Acquire phase from the run's
own `phase_end` event in metrics.jsonl (Burn-in and Learning beside it).
The layouts run in turn, `--repeats` times, so that a drift of the host
shows in every layout alike.  By default the process counts are 1 and 2,
and 4 where the machine has four CUDA cards (a card per rank: nccl; two
ranks on one card share it over gloo).

Prints one JSON line per run (`ms_per_step` of B, L, A, the backend, the
card's name and power limit from nvidia-smi, null on the CPU), then one
line per layout with the median Acquire ms/step and its ratio to the local
run's median.  The reference's tools/scale_procs.py measured steps/s of a
fake-device mesh in one process against two; the port has no fake devices,
so every layout here is a real run of the CLI.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def card_label(device: str):
    """The card's `name, power limit` as nvidia-smi gives them, or None for
    a CPU run."""
    if not device.startswith("cuda"):
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def layouts(procs) -> list:
    """The `--mesh` flag of each run in order, None for the local run."""
    out = []
    for n in procs:
        out += [None] if n == 1 else [f"{n}x1", f"1x{n}"]
    return out


def phase_ms(outdir: pathlib.Path) -> dict:
    """{phase: ms/step} and the backend from a run's metrics.jsonl."""
    events = [json.loads(line) for line in
              (outdir / "metrics.jsonl").read_text().splitlines()]
    ms = {e["phase"]: 1e3 * e["wall_s"] / e["steps"] for e in events
          if e["event"] == "phase_end"}
    start = next(e for e in events if e["event"] == "run_start")
    return {"ms_per_step": ms, "backend": start["backend"],
            "processes": start["processes"]}


def run_one(args, mesh, outdir: pathlib.Path) -> dict:
    cmd = [sys.executable, "-m", "tamcmc_tpu_torch.cli", "run",
           "--demo", args.demo, "--device", args.device, "--seed", "0",
           "--chains", str(args.chains),
           *(["--temps", str(args.temps)] if args.temps else []),
           *(["--ngrid", str(args.ngrid)] if args.ngrid else []),
           *(["--n-orders", str(args.n_orders)] if args.n_orders else []),
           "--burnin", str(args.steps), "--learning", str(args.steps),
           "--acquire", str(args.steps), "--thin", str(args.thin),
           "--chunk", str(args.chunk), "--ckpt-every", str(args.ckpt_every),
           "--no-report", "--outdir", str(outdir),
           *(["--mesh", mesh] if mesh else [])]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {res.returncode}:\n"
                           f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
    return {**phase_ms(outdir),
            "process_seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--demo", default="ms_global")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--temps", type=int,
                    help="temperatures (default: the demo's)")
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--steps", type=int, default=200,
                    help="steps of each phase")
    ap.add_argument("--thin", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--procs", type=int, nargs="+",
                    help="process counts (default: 1 2, and 4 with four "
                         "cards)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--ngrid", type=int)
    ap.add_argument("--n-orders", type=int)
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if args.procs is None:
        import torch
        four = args.device.startswith("cuda") and \
            torch.cuda.device_count() >= 4
        args.procs = [1, 2, 4] if four else [1, 2]
    card = card_label(args.device)
    plan = layouts(args.procs)
    lines, acquire = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(args.repeats):
            for mesh in plan:
                label = mesh or "local"
                out = pathlib.Path(tmp) / f"{label}_{rep}"
                r = run_one(args, mesh, out)
                acquire.setdefault(label, []).append(r["ms_per_step"]["A"])
                line = {"tool": "scale_procs", "demo": args.demo,
                        "mesh": mesh, "repeat": rep, **r,
                        "plan": {"steps": args.steps, "thin": args.thin,
                                 "chunk": args.chunk,
                                 "ckpt_every": args.ckpt_every,
                                 "temps": args.temps, "chains": args.chains},
                        "card": card}
                lines.append(line)
                print(json.dumps(line), flush=True)
    local = statistics.median(acquire["local"]) if "local" in acquire \
        else None
    for label, ms in acquire.items():
        med = statistics.median(ms)
        line = {"tool": "scale_procs", "summary": label,
                "acquire_ms_per_step": ms, "median": med,
                "vs_local": med / local if local else None, "card": card}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(
            "".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
