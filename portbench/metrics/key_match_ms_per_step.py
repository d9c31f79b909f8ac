"""The warm-start key match (`planar._warm_prev`: the [E, P, P] match of
this step's pair keys against the stored ones and the gather of the old
record), device ms per step, from its `physics.key_match` span."""

from portbench.metrics._spans import per_step


def read(run):
    return per_step(run, "physics.key_match")
