"""Busy device ms a step outside the Lorentzian kernels (`lorentz_*`):
the union of the other device operations' intervals in the trace, per
step.  Model assembly, background, prior and sampler operations."""

from benchmark.trace import union_us


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.select(lambda name: not name.startswith("lorentz_"))
    if not ops:
        return None
    return union_us([(a, b) for a, b, _, _ in ops]) / 1e3 / run.trace.steps
