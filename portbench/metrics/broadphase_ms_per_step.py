"""The broadphase (`planar.planar_broadphase`: AABBs and the N x N
overlap test with its pair compaction), device ms per step, from its
`physics.broadphase` span."""

from portbench.metrics._spans import per_step


def read(run):
    return per_step(run, "physics.broadphase")
