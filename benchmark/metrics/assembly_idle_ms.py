"""Idle device ms a step charged to the model assembly and the ARMM solve:
the gaps that a `model.assemble` or `armm.solve` operation ends
(benchmark/spans.py).  None without device operations."""

from benchmark import spans


def read(run):
    if run.spans is None:
        return None
    return spans.layer_metrics(run.spans, run.counters["syncs"]).get(
        "assembly_idle_ms")
