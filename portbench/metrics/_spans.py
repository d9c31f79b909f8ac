"""A stage's device ms per step, from the program's own spans
(`scx_torch.telemetry.trace`): the sum of the device intervals of the
stage's span over the traced stretch, over the number of `physics.step`
spans in it. The profiler of the traced stretch is the only one a run
starts, so the log holds that stretch's spans alone."""

STEP = "physics.step"


def records():
    """The program's closed spans, or None where it records none (a program
    without spans)."""
    try:
        from scx_torch.telemetry import trace
    except ImportError:
        return None
    read = getattr(trace, "spans", None)
    return None if read is None else read()


def per_step(run, name: str, spans=None):
    """Device ms of span `name` per step; None where there are no spans, a
    span has no device interval, or the count of `physics.step` spans is
    not the traced stretch's step count."""
    spans = records() if spans is None else spans
    if not spans or not run.traced_steps:
        return None
    steps = sum(1 for s in spans if s.name == STEP)
    ms = [s.device_ms for s in spans if s.name == name]
    if steps != run.traced_steps or not ms or any(m is None for m in ms):
        return None
    return sum(ms) / steps
