"""Bounded exponential backoff with deterministic jitter.

A copy of the JAX package's ``guard/backoff.py`` (the port imports nothing
of it), so the delay sequence is the same for the same seed. Its consumer
in the port is ``predict_stream``'s co-tenant throttle
(``infer/stream.CoTenantThrottle``):

- **bounded exponential**: attempt ``k`` waits ``base * factor**k``
  seconds, hard-capped at ``max_s`` (the cap applies AFTER jitter);
- **deterministic jitter**: the jitter of attempt ``k`` is a pure
  function of ``(seed, k)`` (one ``random.Random`` seeded from both), so
  tests replay exact schedules and two controllers with different seeds
  desynchronize while each stays reproducible. ``jitter=0`` is exact.
- **reset on success**: one success returns the clock to attempt 0.

The object is also a *schedule*: :meth:`note_failure` arms the next
attempt at ``clock() + delay``, :meth:`ready` answers whether it is due.
Consumers that only want the arithmetic use :meth:`delay_for`.
Thread-safe; ``clock`` is injectable for tests.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Optional


class Backoff:
    """Bounded-exponential-backoff-with-deterministic-jitter policy +
    schedule. See the module docstring for the contract."""

    def __init__(self, base_s: float = 0.5, factor: float = 2.0,
                 max_s: float = 30.0, jitter: float = 0.1,
                 seed: Optional[int] = None,
                 clock=time.monotonic) -> None:
        if base_s < 0:
            raise ValueError("backoff base_s must be >= 0")
        if factor < 1.0:
            raise ValueError("backoff factor must be >= 1")
        if max_s < base_s:
            raise ValueError("backoff max_s must be >= base_s")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("backoff jitter must be in [0, 1)")
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.seed = 0 if seed is None else int(seed)
        self._clock = clock
        self._lock = threading.Lock()
        self._attempts = 0
        self._next_at: Optional[float] = None  # armed: clock() of next try

    # -- pure arithmetic -------------------------------------------------
    def delay_for(self, attempt: int) -> float:
        """The delay AFTER failure number ``attempt`` (0-based), jittered
        deterministically from ``(seed, attempt)`` and capped at
        ``max_s``. Pure: same inputs, same answer, forever."""
        raw = self.base_s * self.factor ** max(int(attempt), 0)
        if self.jitter > 0.0:
            # one derived rng per (seed, attempt): the sequence is a pure
            # function of the seed, independent of call order/count
            u = random.Random((self.seed << 20) ^ (attempt + 1)).random()
            raw *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return min(raw, self.max_s)

    # -- schedule --------------------------------------------------------
    def note_failure(self) -> float:
        """Record one failure: arms the next attempt ``delay_for(k)``
        seconds from now (k = consecutive failures so far) and returns
        that delay."""
        with self._lock:
            delay = self.delay_for(self._attempts)
            self._attempts += 1
            self._next_at = self._clock() + delay
            return delay

    def note_success(self) -> None:
        """Reset to attempt 0 and disarm the schedule."""
        with self._lock:
            self._attempts = 0
            self._next_at = None

    reset = note_success

    def ready(self) -> bool:
        """True when no attempt is pending or its delay has elapsed."""
        with self._lock:
            return self._next_at is None or self._clock() >= self._next_at

    def rearm(self) -> None:
        """Re-arm the CURRENT delay without growing the attempt counter —
        the half-open probe pattern: consuming a probe slot restarts the
        same cooldown window instead of escalating it."""
        with self._lock:
            attempt = max(self._attempts - 1, 0)
            self._next_at = self._clock() + self.delay_for(attempt)

    @property
    def attempts(self) -> int:
        with self._lock:
            return self._attempts

    @property
    def current_delay_s(self) -> float:
        """The delay the NEXT failure would arm (diagnostics)."""
        with self._lock:
            return self.delay_for(self._attempts)

    def snapshot(self) -> dict:
        with self._lock:
            return {"attempts": self._attempts,
                    "armed": self._next_at is not None,
                    "next_delay_s": round(self.delay_for(self._attempts),
                                          4)}
