"""Device operations a step of the ajAlm activity block: those whose layer
is `alm` (launched in an `alm` span, or the backward of one that was;
benchmark/spans.py) over the traced steps.  None without device
operations, or where the program has no `alm` span."""

ALM = "alm"


def read(run):
    sp = run.spans
    if sp is None or not sp.ops or not any(n == ALM for _, _, n in sp.spans):
        return None
    return sum(layer == ALM for _, _, _, layer in sp.ops) / sp.steps
