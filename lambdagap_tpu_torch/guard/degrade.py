"""Serving degradation primitives: shedding, swap circuit breaking, health.

The port of ``lambdagap_tpu/guard/degrade.py`` (its replica-level
``ReplicaUnavailable`` waits for the router):

- :class:`ServeTimeout` / :class:`ServeOverloaded` — a timed-out request
  resolves its Future with ``ServeTimeout`` (shed before dispatch, never
  wasting a device batch on a response nobody is waiting for); a full
  bounded queue under the ``reject`` policy raises ``ServeOverloaded`` at
  submit time.
- :class:`SwapFailed` / :class:`SwapRejected` and :class:`CircuitBreaker`
  — consecutive-failure breaker for model hot-swaps: after ``threshold``
  consecutive failed swaps the circuit opens and further swaps are
  rejected fast (``SwapRejected``) until ``cooldown_s`` passes (then one
  probe swap is allowed through — half-open). The active forest keeps
  serving throughout. The cooldown is fixed: the JAX package's default
  policy (a ``Backoff`` of factor 1 and no jitter) gives the same windows.
- :class:`HealthMonitor` — DEGRADED means "alive but failing" (dispatch
  failures not yet followed by a success, or a non-closed swap breaker);
  DRAINING is terminal (close() in progress). Queue-full rejections alone
  do NOT degrade health: bounded backpressure is the system working as
  designed.
"""
from __future__ import annotations

import threading
import time


class ServeTimeout(TimeoutError):
    """Request deadline (``serve_timeout_ms``) expired before dispatch."""


class ServeOverloaded(RuntimeError):
    """Bounded queue full under the ``reject`` backpressure policy."""


class SwapFailed(RuntimeError):
    """A model hot-swap failed; the previous generation keeps serving."""


class SwapRejected(RuntimeError):
    """Swap refused because the swap circuit breaker is open."""


OK = "ok"
DEGRADED = "degraded"
DRAINING = "draining"


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed -> open -> half_open).

    ``threshold=0`` disables the breaker (always allows). ``clock`` is
    injectable for tests. Thread-safe.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic) -> None:
        self.threshold = int(threshold)
        self._clock = clock
        self._cooldown_s = max(float(cooldown_s), 0.0)
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at = None           # clock() when the circuit opened

    @property
    def cooldown_s(self) -> float:
        return self._cooldown_s

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if (self.threshold > 0 and self._failures >= self.threshold
                    and self._opened_at is None):
                self._opened_at = self._clock()

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None

    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self._cooldown_s:
            return "half_open"
        return "open"

    def allow(self) -> bool:
        """True when an attempt may proceed. In half_open, exactly one
        probe is let through per cooldown window (re-arming the timer so a
        failing probe re-opens the circuit for another full cooldown)."""
        with self._lock:
            st = self._state_locked()
            if st == "closed":
                return True
            if st == "half_open":
                self._opened_at = self._clock()   # consume the probe slot
                return True
            return False

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._failures


class HealthMonitor:
    """OK / DEGRADED / DRAINING for one server. Thread-safe.

    Dispatch outcomes drive the core transition: any failure flips to
    DEGRADED until the next success (``note_ok``) clears it; an open or
    probing swap breaker also reports DEGRADED. ``set_draining`` is sticky.
    """

    def __init__(self, breaker: CircuitBreaker = None) -> None:
        self._lock = threading.Lock()
        self._consecutive_errors = 0
        self._draining = False
        self.breaker = breaker

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
        if self.breaker is not None and self.breaker.state() != "closed":
            return DEGRADED
        return OK

    def snapshot(self) -> dict:
        """The ``health`` block of ``ForestServer.stats_snapshot()``."""
        out = {"state": self.state(),
               "consecutive_dispatch_failures": self.consecutive_errors}
        if self.breaker is not None:
            out["swap_breaker"] = self.breaker.state()
        return out
