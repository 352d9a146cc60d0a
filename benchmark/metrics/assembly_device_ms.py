"""Device ms a step of the model assembly and the ARMM solve: the union
of the device operations whose launch lies in a `model.assemble` or
`armm.solve` span, their backward's with them (benchmark/spans.py).
None without device operations."""

from benchmark import spans


def read(run):
    if run.spans is None:
        return None
    return spans.layer_metrics(run.spans, run.counters["syncs"]).get(
        "assembly_device_ms")
