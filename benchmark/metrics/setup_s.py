"""Host seconds from the start of the process to the first timed step:
imports, the stars' data and problem files, the problems' build (and a
checkout's first kernel build), the state, adaptation and warm-up."""


def read(run):
    return run.setup_s
