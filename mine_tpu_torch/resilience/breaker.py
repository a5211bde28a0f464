"""Circuit breaker around the serving engine (the port's own copy of
mine_tpu/resilience/breaker.py).

  closed     normal operation; consecutive failures are counted.
  open       `failure_threshold` consecutive failures tripped it: requests
             are rejected at once (HTTP 503 + Retry-After) without touching
             the engine, and /healthz reports degraded.
  half-open  after the reset window the next `allow()` admits exactly ONE
             trial request; its success closes the breaker, its failure
             re-opens it.

The reset window is jittered per trip (`reset_jitter`, a +-fraction drawn
from a `random.Random(jitter_seed)`), so that replicas tripped by one event
re-probe at distinct instants; seeded, so the spread is deterministic under
test. Thread-safe; the clock is injectable. `on_state` receives the state
code (0 closed, 1 half-open, 2 open) and `on_trip` each trip.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpen(RuntimeError):
    """Rejected because the breaker is open (maps to HTTP 503)."""

    def __init__(self, retry_after_s: float):
        super().__init__(
            f"circuit breaker open; retry after {retry_after_s:.1f}s"
        )
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        reset_after_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        on_state: Callable[[int], None] | None = None,
        on_trip: Callable[[], None] | None = None,
        reset_jitter: float = 0.0,
        jitter_seed: int | None = None,
    ):
        if failure_threshold < 0:
            raise ValueError(f"failure_threshold must be >= 0, got "
                             f"{failure_threshold}")
        if not 0.0 <= reset_jitter < 1.0:
            raise ValueError(
                f"reset_jitter must be in [0, 1), got {reset_jitter}"
            )
        # threshold 0 disables the breaker entirely (allow() is always True)
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self.reset_jitter = float(reset_jitter)
        self._jitter_rng = random.Random(
            0 if jitter_seed is None else jitter_seed
        )
        # the window actually in force for the CURRENT open period;
        # re-drawn at every trip (guarded-by: self._lock)
        self._effective_reset_s = self.reset_after_s
        self._clock = clock
        self._on_state = on_state
        self._on_trip = on_trip
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._trial_inflight = False
        self.trips = 0
        if on_state is not None:
            on_state(STATE_CODES[CLOSED])

    # -- state ----------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _set_state_locked(self, state: str) -> None:
        self._state = state
        if self._on_state is not None:
            self._on_state(STATE_CODES[state])

    def _maybe_half_open_locked(self) -> None:
        if (self._state == OPEN
                and self._clock() - self._opened_at
                >= self._effective_reset_s):
            self._set_state_locked(HALF_OPEN)
            self._trial_inflight = False

    def retry_after_s(self) -> float:
        """Seconds until the breaker half-opens (0 when not open)."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(
                0.0,
                self._effective_reset_s - (self._clock() - self._opened_at),
            )

    # -- admission ------------------------------------------------------------

    def rejecting(self) -> bool:
        """Pure admission probe: True while open (before the reset timer).
        Does NOT consume the half-open trial slot — use at enqueue time so
        the trial is spent by the dispatch-time `allow()`, not by admission.
        """
        with self._lock:
            self._maybe_half_open_locked()
            return self._state == OPEN

    def allow(self) -> bool:
        """Dispatch-time gate. In half-open state admits exactly one trial
        at a time; the trial's record_success/record_failure decides."""
        if self.failure_threshold == 0:
            return True
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._trial_inflight:
                self._trial_inflight = True
                return True
            return False

    # -- outcomes -------------------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._trial_inflight = False
            if self._state != CLOSED:
                self._set_state_locked(CLOSED)

    def record_failure(self) -> None:
        if self.failure_threshold == 0:
            return
        with self._lock:
            self._consecutive_failures += 1
            self._trial_inflight = False
            should_trip = (
                self._state == HALF_OPEN
                or (self._state == CLOSED
                    and self._consecutive_failures >= self.failure_threshold)
            )
            if should_trip:
                self._opened_at = self._clock()
                # draw this open period's recovery window: replicas
                # sharing a trip instant still re-probe at distinct ones
                self._effective_reset_s = self.reset_after_s * (
                    1.0 + self.reset_jitter
                    * self._jitter_rng.uniform(-1.0, 1.0)
                )
                if self._state != OPEN:
                    self.trips += 1
                    if self._on_trip is not None:
                        self._on_trip()
                self._set_state_locked(OPEN)
