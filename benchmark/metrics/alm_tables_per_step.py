"""Evaluations of the ajAlm activity filter a step: the program's host
counter `alm_tables` (keyed; one a forward of the ajAlm assembly) moved
over the traced steps, over the steps.  None where the program has no
such counter."""


def read(run):
    if run.spans is None or run.counters is None \
            or "alm_tables" not in run.counters:
        return None
    return sum(run.counters["alm_tables"].values()) / run.spans.steps
