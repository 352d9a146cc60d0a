"""The sum over the stars of the cold rung's ESS over the window's theta0
records (the median over each star's free parameters), over the window's
host seconds."""


def read(run):
    return sum(run.ess) / run.window_s
