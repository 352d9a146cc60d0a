"""Run one cell of BENCHMARK.json once and print its result line.

    python benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Prints one JSON object as the last line of standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), `device`, with
--trace 1 `breakdown`, then `numbers` (every number the check computed)
and `checks` (the numbers the cell compares, each with its limit), which
also end standard error.  Exits 2 without a result when the cards are
missing, 3 when the process holds a module of JAX or of the JAX package.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tamcmc_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    args = harness.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.traffic["chips"]:
        log(f"{args.workload} needs {cell.traffic['chips']} CUDA card(s); "
            f"this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
