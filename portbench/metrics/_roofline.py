"""A kernel's share of its roofline: the least time an H100 could take for
the work of the traced stretch's last step (portbench.bounds, counted from
its inputs) over the kernel's mean device time per launch in the trace."""


def share(run, kernel: str, bound_ms):
    """100 * bound / mean launch time, or None where the trace holds no
    launch of `kernel` or there is no bound."""
    if run.trace is None or bound_ms is None:
        return None
    us = run.trace.kernel_us(kernel)
    if not us:
        return None
    return 100.0 * bound_ms / (sum(us) / len(us) / 1e3)
