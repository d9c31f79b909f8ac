"""The staged route's solve pack (`planar.solve_pack`: solver set-up,
the one-hot per-body sums and the [E, 168, P] pack), device ms per step,
from its `physics.solve_pack` span."""

from portbench.metrics._spans import per_step


def read(run):
    return per_step(run, "physics.solve_pack")
