"""Device ms a step of the sampler's own operations outside the Lorentzian
kernels and the assembly: the union of the device operations in every
other span (proposal, acceptance, likelihood chain, prior, swaps,
records; benchmark/spans.py).  None without device operations."""

from benchmark import spans


def read(run):
    if run.spans is None:
        return None
    return spans.layer_metrics(run.spans, run.counters["syncs"]).get(
        "sampler_device_ms")
