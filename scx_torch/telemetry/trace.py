"""Device-level tracing via torch.profiler (port of scx.telemetry.trace,
whose capture is jax.profiler's); host-side scope parity lives in
scx_torch.core.timing.

The reference's scopes can only see host wall time. On the card the host
loop dispatches kernels and the truth lives in the device trace: kernel
spans, copies, idle gaps. `start_trace`/`stop_trace` capture a Chrome /
Perfetto trace (CPU and, where there is a card, CUDA activity), and
`annotate` brackets host spans (`torch.profiler.record_function`) so
scheduler systems show up alongside device activity. With no trace live,
`annotate` is a no-op.

Usage:
    from scx_torch.telemetry import trace
    trace.start_trace("build/scx_trace")
    for _ in range(30): sandbox.frame()
    trace.stop_trace()      # open trace.json in ui.perfetto.dev
"""

from __future__ import annotations

import contextlib
import os

import torch

_active = False
_prof = None
_logdir = None


def start_trace(logdir: str) -> None:
    """Begin a profiler capture (device + host annotations)."""
    global _active, _prof, _logdir
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _prof = torch.profiler.profile(activities=acts)
    _prof.__enter__()
    _logdir = logdir
    _active = True


def stop_trace() -> None:
    """End the capture and write it to <logdir>/trace.json."""
    global _active, _prof
    if _active:
        _prof.__exit__(None, None, None)
        _prof.export_chrome_trace(os.path.join(_logdir, "trace.json"))
        _prof = None
        _active = False


def tracing_active() -> bool:
    return _active


def annotate(name: str):
    """Host-span annotation visible in the captured trace; no-op (and
    near-zero cost) when no trace is active."""
    if not _active:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def profile_frames(sandbox, n_frames: int, logdir: str, **frame_kw):
    """Capture `n_frames` engine frames into `logdir` (convenience used by
    the viewer's --trace flag)."""
    start_trace(logdir)
    try:
        for _ in range(n_frames):
            sandbox.frame(**frame_kw)
    finally:
        stop_trace()
    return logdir
