"""Device operations (kernels and copies) in the traced window per call of
the entry point: per fleet step (physics) or per `CityRLEnv.step`."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    return run.trace.launches / run.traced_steps
