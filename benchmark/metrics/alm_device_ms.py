"""Device ms a step of the ajAlm activity block: the union of the device
operations whose launch lies in an `alm` span (the filter's table and each
degree's shifts), their backward's with them (benchmark/spans.py).  None
without device operations, or where the program has no `alm` span."""

ALM = "alm"


def read(run):
    sp = run.spans
    if sp is None or not sp.ops or not any(n == ALM for _, _, n in sp.spans):
        return None
    return sp.device_ms(lambda layer: layer == ALM)
