"""`host_step_ms` of the dense-mode cells, whose step moves
`walker_steps_per_s.dense`."""

from benchmark.harness import read_metric


def read(run):
    return read_metric("host_step_ms", run)
