"""Serving degradation primitives: shedding exceptions and health.

The part of ``lambdagap_tpu/guard/degrade.py`` the port's one-model server
needs: the two shedding exceptions and the OK / DEGRADED / DRAINING
:class:`HealthMonitor`. The swap circuit breaker waits for the registry
and hot-swap slice.

- :class:`ServeTimeout` / :class:`ServeOverloaded` — a timed-out request
  resolves its Future with ``ServeTimeout`` (shed before dispatch, never
  wasting a device batch on a response nobody is waiting for); a full
  bounded queue under the ``reject`` policy raises ``ServeOverloaded`` at
  submit time.
- :class:`HealthMonitor` — DEGRADED means "alive but failing" (dispatch
  failures not yet followed by a success); DRAINING is terminal (close()
  in progress). Queue-full rejections alone do NOT degrade health:
  bounded backpressure is the system working as designed.
"""
from __future__ import annotations

import threading


class ServeTimeout(TimeoutError):
    """Request deadline (``serve_timeout_ms``) expired before dispatch."""


class ServeOverloaded(RuntimeError):
    """Bounded queue full under the ``reject`` backpressure policy."""


OK = "ok"
DEGRADED = "degraded"
DRAINING = "draining"


class HealthMonitor:
    """OK / DEGRADED / DRAINING for one server. Thread-safe.

    Dispatch outcomes drive the transition: any failure flips to DEGRADED
    until the next success (``note_ok``) clears it. ``set_draining`` is
    sticky.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._consecutive_errors = 0
        self._draining = False

    def note_error(self) -> None:
        with self._lock:
            self._consecutive_errors += 1

    def note_ok(self) -> None:
        with self._lock:
            self._consecutive_errors = 0

    def set_draining(self) -> None:
        with self._lock:
            self._draining = True

    @property
    def consecutive_errors(self) -> int:
        with self._lock:
            return self._consecutive_errors

    def state(self) -> str:
        with self._lock:
            if self._draining:
                return DRAINING
            if self._consecutive_errors > 0:
                return DEGRADED
        return OK

    def snapshot(self) -> dict:
        """The ``health`` block of ``ForestServer.stats_snapshot()``."""
        return {"state": self.state(),
                "consecutive_dispatch_failures": self.consecutive_errors}
