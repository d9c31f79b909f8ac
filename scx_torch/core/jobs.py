"""Host job system — the thread-pool analogue of the reference's workers.

Copy of scx.core.jobs, which imports no JAX (every scx subpackage does
when it is imported, so the port keeps its own copy).

The reference runs a lock-free MPMC work-stealing pool with Dispatch
(parallel-for + fence), DispatchAsync (fire-and-forget) and help-while-wait
(sc_jobs.h:70-183, sc_jobs.cpp).  Here frame-parallel compute belongs to
the device; what remains for host threads is IO-bound work — sector
loads, asset decode, checkpoint writes.  This wrapper gives those the same
API surface (Dispatch/DispatchAsync/fences, per-frame telemetry) over
concurrent.futures, so subsystems read like their reference counterparts.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field


@dataclass
class JobStats:
    """Telemetry snapshot (publishFrameTelemetry mirror, sc_jobs.cpp:150-200)."""

    workers: int = 0
    dispatched: int = 0
    completed: int = 0
    async_jobs: int = 0
    busy_ms: float = 0.0


class JobSystem:
    """Dispatch/DispatchAsync over a thread pool with fence futures."""

    def __init__(self, workers: int | None = None):
        import os

        self.workers = workers if workers is not None else max(1, (os.cpu_count() or 2) - 1)
        self._pool = ThreadPoolExecutor(max_workers=self.workers)
        self._lock = threading.Lock()
        self._stats = JobStats(workers=self.workers)
        self._frame_stats = JobStats(workers=self.workers)

    def dispatch(self, count: int, group_size: int, fn) -> None:
        """Parallel-for over [0, count) in groups; BLOCKS until done
        (Dispatch + fence wait semantics, sc_jobs.h:70-134)."""
        if count <= 0:
            return
        group_size = max(1, group_size)
        t0 = time.perf_counter()
        futures = []
        for start in range(0, count, group_size):
            end = min(start + group_size, count)

            def run(s=start, e=end):
                for i in range(s, e):
                    fn(i)

            futures.append(self._pool.submit(run))
        with self._lock:
            self._stats.dispatched += len(futures)
        wait(futures)
        for f in futures:
            f.result()  # propagate exceptions
        with self._lock:
            self._stats.completed += len(futures)
            self._stats.busy_ms += (time.perf_counter() - t0) * 1e3

    def dispatch_async(self, fn, *args) -> Future:
        """Fire-and-forget (DispatchAsync, sc_jobs.h:136-183)."""
        with self._lock:
            self._stats.async_jobs += 1
        return self._pool.submit(fn, *args)

    def begin_frame(self) -> JobStats:
        """Publish and reset the per-frame stats snapshot."""
        with self._lock:
            snap = JobStats(**self._stats.__dict__)
            self._frame_stats = snap
            self._stats = JobStats(workers=self.workers)
        return snap

    @property
    def frame_stats(self) -> JobStats:
        return self._frame_stats

    def shutdown(self):
        self._pool.shutdown(wait=True)


_global: JobSystem | None = None


def jobs() -> JobSystem:
    """Global job system singleton (the jobs() accessor, sc_jobs.cpp:113-118)."""
    global _global
    if _global is None:
        _global = JobSystem()
    return _global
