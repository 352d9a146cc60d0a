"""Cells of BENCHMARK.json cut to sizes a CPU test can hold."""

import dataclasses

from benchmark import harness
from benchmark.reference import family


def cell(name, config=None, **traffic):
    """The cell `name` with its configuration's keys `config` replaced and
    its traffic's keys `traffic` replaced."""
    c = harness.load_cell(name)
    return dataclasses.replace(c, config=dict(c.config, **(config or {})),
                               traffic=dict(c.traffic, **traffic))


SMALL_RUN = {"stars": 2, "chains": 4, "chunk": 2, "check_walkers": 8,
             "check_block": 4}


def small(name, **traffic):
    """The cell at its family's small grid (its SMALL keys) and few
    walkers."""
    c = harness.load_cell(name)
    conf = family(c.config["family"]).SMALL
    run = dict(SMALL_RUN, adapt_steps=min(c.traffic["adapt_steps"], 20),
               **traffic)
    if c.traffic["stars"] == 1:
        run["stars"] = 1
    return cell(name, conf, **run)
