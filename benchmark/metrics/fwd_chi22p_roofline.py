"""The forward kernel with the chi22p epilogue (`lorentz_fwd*chi22p*`):
the least time of its counted work at this run's walkers, component-bins
and precision (benchmark/work.py) over its mean device time a launch in
the trace, in percent."""

from benchmark import work


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.select(lambda n: n.startswith("lorentz_fwd")
                           and "chi22p" in n)
    if not ops:
        return None
    ms = sum(b - a for a, b, _, _ in ops) / 1e3 / len(ops)
    bound = work.kernel_bound_ms("fwd_chi22p", run.walkers, run.n_comp,
                                 run.n_bins, run.comp_bins, run.precision,
                                 spec_rows=run.stars)
    return 100.0 * bound / ms
