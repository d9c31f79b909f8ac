"""Device timing of a call on the GPU: the entry point with CUDA events,
one CUDA kernel alone with torch.profiler. Used by chip_smoke.py and the
profile_* scripts; needs a CUDA device."""

from __future__ import annotations

import torch


def cuda_ms(fn, reps):
    """Mean ms per call of fn between CUDA events around `reps` calls after
    one warm-up: the entry point as a caller sees it, host dispatch
    included."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


KERNEL_MS_SESSIONS = 3  # profiler sessions kernel_ms runs before it gives up


def kernel_ms(fn, reps, name):
    """Mean device time of one launch of the CUDA kernel whose name holds
    `name`, over the launches traced in `reps` calls of fn after one
    warm-up (the tracer may drop one). Now and then the profiler loses a
    whole session's device records while its host records show the
    launches, so a session that traced no such launch is run again, up to
    KERNEL_MS_SESSIONS in all, before it raises."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(KERNEL_MS_SESSIONS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA and name in ev.name]
        if us:
            return sum(us) / len(us) / 1e3
    raise RuntimeError(f"{name}: no launch traced in {KERNEL_MS_SESSIONS} sessions of {reps} calls")
