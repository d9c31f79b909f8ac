"""The tail of the step (`planar._finish_step`: sleep, position
integration and the per-env stats), device ms per step, from its
`physics.finish` span."""

from portbench.metrics._spans import per_step


def read(run):
    return per_step(run, "physics.finish")
