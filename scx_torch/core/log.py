"""Leveled printf-style logging (reference: sc_log.h:6-9, sc_log.cpp:19-33).

Copy of scx.core.log, which imports no JAX (every scx subpackage does
when it is imported, so the port keeps its own copy).

Thin wrapper over the stdlib so host tooling logs uniformly; includes the
reference's rate-limited warning helper (sc_traffic_ai.cpp:397-407 pattern).
"""

from __future__ import annotations

import logging
import time

_logger = logging.getLogger("scx")
if not _logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)

debug = _logger.debug
info = _logger.info
warn = _logger.warning
error = _logger.error

_rate_state: dict[str, float] = {}


def warn_rate_limited(key: str, interval_s: float, msg: str, *args) -> bool:
    """Emit a warning at most once per `interval_s` per key; returns True if
    emitted."""
    now = time.monotonic()
    last = _rate_state.get(key, -1e18)
    if now - last >= interval_s:
        _rate_state[key] = now
        _logger.warning(msg, *args)
        return True
    return False


def set_level(level: str) -> None:
    _logger.setLevel(getattr(logging, level.upper()))
