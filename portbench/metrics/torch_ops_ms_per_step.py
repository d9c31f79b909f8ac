"""Device ms per step of every operation that is not one of the port's
hand-written kernels (portbench.trace.PORT_KERNELS): the plain-PyTorch
layers around them."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    us = sum(e - s for n, s, e in run.trace.device if not run.trace.is_port_kernel(n))
    return us / 1e3 / run.traced_steps
