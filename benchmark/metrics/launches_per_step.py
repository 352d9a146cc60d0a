"""Device operations (kernels, copies, fills) in the traced steps'
profiler trace, per step."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return len(run.trace.ops) / run.trace.steps
