"""`bwd_roofline` in the dense-mode cells (the kernel's dense mode),
whose step moves `walker_steps_per_s.dense`."""

from benchmark.harness import read_metric


def read(run):
    return read_metric("bwd_roofline", run)
