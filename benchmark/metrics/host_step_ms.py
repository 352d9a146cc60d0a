"""Host ms a step inside the program's `step` spans over the traced
steps, less the time in runtime calls that waited (a full launch queue
or a synchronise): the host's own work to enqueue a step
(benchmark/spans.py)."""

from benchmark import spans


def read(run):
    if run.spans is None:
        return None
    return spans.layer_metrics(run.spans, run.counters["syncs"]).get(
        "host_step_ms")
