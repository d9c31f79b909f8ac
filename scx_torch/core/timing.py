"""Named-scope wall timing for the host loop.

Copy of scx.core.timing, which imports no JAX (every scx subpackage does
when it is imported, so the port keeps its own copy).

Mirrors the reference's global scope registry + ScopedTimer + top-N snapshot
(reference: sc_time.h:24-39, sc_time.cpp:27-122): up to `MAX_SCOPES` named
scopes, each an accumulating counter drained by `snapshot_top_scopes`.

On-device timing is the profiler's business (scx_torch.telemetry.trace); these scopes
time host-side dispatch boundaries — which is what the reference's scopes
measured too (whole-system wall time).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

MAX_SCOPES = 64
TOP_SCOPES = 5

_lock = threading.Lock()
_scopes: dict[str, int] = {}  # name -> accumulated ns
_order: list[str] = []


def register_scope(name: str) -> str:
    """Register (idempotently) a named scope; returns the name as handle."""
    with _lock:
        if name not in _scopes:
            if len(_scopes) >= MAX_SCOPES:
                return name  # over capacity: still usable, not tracked
            _scopes[name] = 0
            _order.append(name)
    return name


def add_scope_time(name: str, ns: int) -> None:
    with _lock:
        if name in _scopes:
            _scopes[name] += ns


class ScopedTimer:
    """RAII-style scope timer: `with ScopedTimer("Physics/Step"): ...`."""

    def __init__(self, name: str):
        self.name = register_scope(name)
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        add_scope_time(self.name, time.perf_counter_ns() - self._t0)
        return False


@dataclass
class ScopeSample:
    name: str
    ms: float


def snapshot_top_scopes(top: int = TOP_SCOPES) -> list[ScopeSample]:
    """Drain all scope accumulators, return top-N by accumulated ms
    (reference sc_time.cpp:84-122)."""
    with _lock:
        items = [(n, _scopes[n]) for n in _order if _scopes[n] > 0]
        for n in _scopes:
            _scopes[n] = 0
    items.sort(key=lambda kv: kv[1], reverse=True)
    return [ScopeSample(n, ns / 1e6) for n, ns in items[:top]]
