"""The whole step's share of the card's peak: the step's least time
(both kernels' counted work and the likelihood's operations a walker-bin,
benchmark/work.py) over the traced window's host ms a step, in percent."""

from benchmark import work


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    bound = work.step_bound_ms(run.walkers, run.n_comp, run.n_bins,
                               run.comp_bins, run.precision,
                               spec_rows=run.stars)
    return 100.0 * bound / (1e3 * run.trace.window_s / run.trace.steps)
