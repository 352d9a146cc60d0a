"""Readings of a cell's compared numbers on many seeds in one process, for
setting its limits: the program as the cell runs it, and with --control
the program in the cell's control precision (the precision below the one
its configuration states).

    python benchmark/tools/readings.py --workload CELL --seeds 1 2 3
        [--control] [--seconds 5] [--out chiprun_out/readings.jsonl]

One JSON line a run: the seed, whether it ran the control, the numbers
and the checks against the cell's current limits.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, device, t0,
                          control=args.control,
                          log=lambda m: print(f"# {m}", file=sys.stderr))
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "control": args.control,
                           "correct": out["correct"],
                           "numbers": out["numbers"],
                           "metrics": out["metrics"],
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
