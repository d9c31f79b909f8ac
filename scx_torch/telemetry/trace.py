"""Device-level tracing via torch.profiler (port of scx.telemetry.trace,
whose capture is jax.profiler's); host-side scope parity lives in
scx_torch.core.timing.

The reference's scopes can only see host wall time. On the card the host
loop dispatches kernels and the truth lives in the device trace: kernel
spans, copies, idle gaps. `start_trace`/`stop_trace` capture a Chrome /
Perfetto trace (CPU and, where there is a card, CUDA activity).

Spans. `annotate(name)` (a `with` block) and `span(name)` (a decorator)
record a span whenever a torch profiler is recording in this process:
`start_trace`'s, any `torch.profiler.profile`, a benchmark's capture. A
span has two sides:

- host: a FUNCTION-scope record function, so it sits in the trace's host
  timeline nested under its caller, on the device events' clock. It is not
  a user annotation (`torch.profiler.record_function`), which the profiler
  would mirror onto the device's timeline;
- device: where CUDA is initialised, a timing `torch.cuda.Event` on the
  current stream at enter and at exit. The interval between them is the
  span's device time: its kernels and any idle between them.

Each span is kept in a bounded in-memory log (name, parent, host start and
end, the two events); the oldest go when it is full, and are counted.
`spans()` synchronises once and returns the closed spans with their device
ms; `clear_spans()` empties the log. With no profiler recording, a span is
a shared null context: no allocation, no CUDA call.

Usage:
    from scx_torch.telemetry import trace
    trace.start_trace("build/scx_trace")
    for _ in range(30): sandbox.frame()
    trace.stop_trace()      # open trace.json in ui.perfetto.dev
    trace.spans()           # the spans of those frames, device ms and all
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from dataclasses import dataclass, field

import torch

_active = False
_prof = None
_logdir = None

# Whether a torch profiler is recording in this process (~100 ns); tests
# replace it to trace a step with its spans off.
_recording = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
MAX_SPANS = 4096  # spans the log keeps; older ones are dropped and counted


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


@dataclass(eq=False)
class Span:
    """One recorded span. parent is the `seq` of the span it opened in (on
    the same thread), None at the top; host times are perf_counter ns;
    device_ms is None where CUDA was not initialised."""

    name: str
    seq: int
    parent: int | None
    host_start_ns: int
    host_end_ns: int | None = None
    device_ms: float | None = None
    _events: tuple | None = field(default=None, repr=False)  # (device index, start, end)


class SpanLog:
    """The bounded log of spans and the pool of timing events they use."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self._records = collections.deque()
        self._max = max_spans
        self._seq = itertools.count()
        self._local = threading.local()
        self._pool = collections.defaultdict(list)  # device index -> free events
        self.dropped = 0

    def _event(self, dev: int):
        pool = self._pool[dev]
        return pool.pop() if pool else torch.cuda.Event(enable_timing=True)

    def _release(self, rec: Span) -> None:
        """Pool a closed span's events; an open one's are in use: dropped."""
        if rec._events is not None and rec.host_end_ns is not None:
            dev, a, b = rec._events
            self._pool[dev] += (a, b)
        rec._events = None

    def _record(self, ev, dev: int) -> None:
        """ev.record() on the current stream of device `dev`. The stream
        object is kept per thread and checked against the raw stream, which
        costs ~0.1 us where `torch.cuda.current_stream()` costs ~5 (an H100
        host under a profiler)."""
        raw = torch._C._cuda_getCurrentRawStream(dev)
        streams = self._local.streams
        if dev not in streams or streams[dev][0] != raw:
            streams[dev] = (raw, torch.cuda.current_stream(dev))
        ev.record(streams[dev][1])

    def open(self, name: str) -> Span:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            self._local.streams = {}
        rec = Span(name, next(self._seq), stack[-1].seq if stack else None,
                   time.perf_counter_ns())
        if torch.cuda.is_initialized():
            dev = torch.cuda.current_device()
            rec._events = (dev, self._event(dev), self._event(dev))
            self._record(rec._events[1], dev)
        if len(self._records) >= self._max:
            self._release(self._records.popleft())
            self.dropped += 1
        self._records.append(rec)
        stack.append(rec)
        return rec

    def close(self, rec: Span) -> None:
        if rec._events is not None:
            self._record(rec._events[2], rec._events[0])
        rec.host_end_ns = time.perf_counter_ns()
        self._local.stack.pop()

    def spans(self) -> list:
        """The closed spans, oldest first, each with its device ms."""
        done = [r for r in self._records if r.host_end_ns is not None]
        timed = [r for r in done if r._events is not None]
        for dev in {r._events[0] for r in timed}:
            torch.cuda.synchronize(dev)
        for r in timed:
            r.device_ms = r._events[1].elapsed_time(r._events[2])
            self._release(r)
        return done

    def clear(self) -> None:
        for r in self._records:
            self._release(r)
        self._records.clear()
        self.dropped = 0


_log = SpanLog()


class _Recorded:
    """A span while a profiler records: both sides, as the module says."""

    __slots__ = ("name", "_rf", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        self._rec = _log.open(self.name)
        return self

    def __exit__(self, *exc):
        _log.close(self._rec)
        self._rf.__exit__(*exc)
        return False


def annotate(name: str):
    """A span named `name` over a `with` block while a torch profiler
    records; the shared null context otherwise."""
    if not _recording():
        return _NULL
    return _Recorded(name)


def span(name: str):
    """Decorator: each call of the function is a span named `name` (see
    annotate)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _Recorded(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> list:
    """The spans recorded since the last clear_spans(), oldest first (at most
    MAX_SPANS), each with its device ms; synchronises once per device."""
    return _log.spans()


def dropped_spans() -> int:
    """Spans dropped from the full log since the last clear_spans()."""
    return _log.dropped


def clear_spans() -> None:
    _log.clear()
