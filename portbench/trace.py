"""A torch.profiler trace of a few steps of the timed path, reduced to what
the per-layer metrics and the result's breakdown read: the traced window,
the device's operations in it (kernels and copies), their union (busy
time), and the idle gaps named by what the host was doing in them.

Spans: the harness wraps the traced stretch in `portbench.window` and each
call into the program's entry point in `portbench.step`."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import stats

WINDOW, STEP = "portbench.window", "portbench.step"
# the port's hand-written kernels (physics/csrc/*.cu, ops/csrc/raster.cu),
# by the names the trace gives them; every other device operation is
# PyTorch's
PORT_KERNELS = ("planar_middle_kernel", "planar_sat_kernel", "planar_solve_kernel",
                "tile_raster_kernel", "cluster_raster_kernel")


@dataclass
class Trace:
    window: tuple            # (start us, end us) of the traced stretch
    device: list             # (name, start us, end us) of each device operation in it
    host: list = field(repr=False, default_factory=list)  # (name, start, end) host ops

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_us(self) -> float:
        return stats.union_us([(s, e) for _, s, e in self.device], *self.window)

    @property
    def launches(self) -> int:
        return len(self.device)

    def kernel_us(self, name: str) -> list:
        """Device time of each launch of the kernel whose name holds `name`."""
        return [e - s for n, s, e in self.device if name in n]

    def is_port_kernel(self, name: str) -> bool:
        return any(k in name for k in PORT_KERNELS)

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n] += e - s
        return [[n, us / 1e6] for n, us in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, seconds]] of the device's idle time: each
        gap named by the innermost `portbench.*` span and the innermost host
        operation over its middle, summed by name."""
        holes = stats.gaps([(s, e) for _, s, e in self.device], *self.window)
        if not holes:
            return []
        names = [n for n, _, _ in self.host]
        hs = np.array([s for _, s, _ in self.host] or [0.0])
        he = np.array([e for _, _, e in self.host] or [0.0])
        span = np.array([n.startswith("portbench.") and n != WINDOW for n in names] or [False])
        op = np.array([not n.startswith("portbench.") for n in names] or [False])
        by = defaultdict(float)
        for s, e in holes:
            mid = 0.5 * (s + e)
            cover = (hs <= mid) & (he >= mid) if self.host else np.zeros(1, bool)
            label = []
            for kind in (span, op):
                idx = np.flatnonzero(cover & kind)
                if idx.size:
                    label.append(names[idx[np.argmin((he - hs)[idx])]])
            by[" / ".join(label) or "outside any host operation"] += e - s
        return [[n, us / 1e6] for n, us in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def capture(fn):
    """(fn's result, Trace) of fn() run under torch.profiler (host and
    device), inside a `portbench.window` span that ends after a
    synchronize."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    return out, reduce(prof.events())


def reduce(events) -> Trace:
    """The Trace of a profiler's events. A `record_function` span is also
    mirrored onto the device's timeline; those mirrors are not device work."""
    window, device, host = None, [], []
    for ev in events:
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not ev.name.startswith(("portbench.", "Optimizer.", "ProfilerStep")):
                device.append((ev.name, s, e))
        elif ev.name == WINDOW:
            window = (s, e)
        else:
            host.append((ev.name, s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    device = [(n, s, e) for n, s, e in device if e > window[0] and s < window[1]]
    return Trace(window=window, device=device, host=host)
