"""The fused middle (physics/csrc/planar_middle.cu) against its roofline,
on the work of the traced stretch's last step."""

from portbench import bounds
from portbench.metrics._roofline import share


def read(run):
    work = run.probe.get("work")
    if work is None:
        return None
    return share(run, "planar_middle_kernel", bounds.middle_bound(work)[0])
