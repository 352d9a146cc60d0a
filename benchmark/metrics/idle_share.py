"""1 - busy device time / the traced window's host seconds, in percent:
how far the host holds the card back."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
