"""MALA steps completed in the window times the walkers of every star and
rung, over the window's host seconds (host clock, ended by a synchronise)."""


def read(run):
    return run.window_steps * run.walkers / run.window_s
