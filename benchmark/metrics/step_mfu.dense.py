"""`step_mfu` of the dense-mode cells: a metric of their own,
since the host's launches (the ARMM solver's bisection) share their pace
and their wider spread is to set no bound for the device-paced cells."""

from benchmark.harness import read_metric


def read(run):
    return read_metric("step_mfu", run)
