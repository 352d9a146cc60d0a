"""The ess_per_s numerator over the window's cold-rung walker-steps: the
MALA step's and the swaps' mixing, with the time taken out."""


def read(run):
    return sum(run.ess) / (run.window_steps * run.stars * run.chains)
