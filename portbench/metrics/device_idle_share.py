"""The share of the traced window in which no operation ran on the device:
1 - (union of kernel and copy intervals) / window."""


def read(run):
    if run.trace is None or run.trace.window_us <= 0:
        return None
    return 1.0 - run.trace.busy_us / run.trace.window_us
