"""Synchronising CUDA calls a step over the traced steps: the program's
`syncs` counter (each call the sync debug mode warns at, while tracing
is on) over the steps.  0 on a CPU, where nothing synchronises."""

from benchmark import spans


def read(run):
    if run.spans is None:
        return None
    return spans.layer_metrics(run.spans, run.counters["syncs"]).get(
        "host_syncs_per_step")
