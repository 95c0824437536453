"""Resilience primitives: the retry policy with jittered backoff, and a
per-node circuit breaker.

The JAX package's ``utils/resilience.py``, kept whole:

- :class:`RetryPolicy` — bounded, jittered exponential backoff. Naive
  synchronized retries are how rate limiters melt their own backends: a
  fleet of clients that all retry at t+1s is a thundering herd with a
  timer. Full jitter on the top half of the delay decorrelates them. The
  policy object is pure (delay computation only); WHO may retry WHAT is
  the caller's contract — see the at-most-once rules in
  ``runtime/remote.py``.
- :class:`CircuitBreaker` — the closed/open/half-open state machine the
  cluster (``runtime/cluster.py``) keeps per node. While open, callers
  shed (or serve a degraded fallback) instead of queueing behind a dead
  peer's timeout; after ``recovery_timeout_s`` ONE probe at a time
  re-tests the node (half-open), so a still-down node costs one request
  per window, not a stampede.

Both are free of I/O and asyncio: deterministic under a seeded
``random.Random`` / manual clock.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable

__all__ = ["RetryPolicy", "BreakerConfig", "CircuitBreaker"]


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with decorrelated exponential backoff.

    ``delay_s(attempt, rng)`` for attempt 1, 2, … grows as
    ``base · multiplier^(attempt-1)`` capped at ``max_delay_s``, with
    the top ``jitter`` fraction drawn uniformly (full-jitter on half
    the delay by default: herds decorrelate, yet the floor keeps the
    backoff meaningfully exponential).
    """

    max_attempts: int = 3          #: total tries, the first included
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5            #: fraction of the delay randomized

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def delay_s(self, attempt: int, rng: "random.Random") -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        raw = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** max(0, attempt - 1))
        return raw * (1.0 - self.jitter + self.jitter * rng.random())

    def max_total_delay_s(self) -> float:
        """Worst-case sum of all backoff sleeps — what a blocking caller
        adds to its own grace timeout so retries can finish."""
        return sum(
            min(self.max_delay_s, self.base_delay_s * self.multiplier ** i)
            for i in range(self.max_attempts - 1))


@dataclass(frozen=True)
class BreakerConfig:
    """Knobs of one :class:`CircuitBreaker` (docs/OPERATIONS.md §8)."""

    #: Consecutive failures that trip CLOSED → OPEN.
    failure_threshold: int = 5
    #: How long OPEN sheds before admitting a half-open probe.
    recovery_timeout_s: float = 1.0
    #: Consecutive half-open successes required to re-close.
    half_open_successes: int = 1


class CircuitBreaker:
    """Closed/open/half-open circuit breaker, single-threaded by design
    (all mutation happens on one event loop; the GIL guards the stray
    cross-thread read of ``state``).

    ``allow()`` is the admission gate and returns one of:

    - ``"allow"``  — CLOSED: proceed normally.
    - ``"reject"`` — OPEN inside the recovery window, or HALF_OPEN with
      the single probe slot already taken: shed / serve degraded.
    - ``"probe"``  — HALF_OPEN and this caller holds the probe slot: it
      MUST settle the probe via ``record_success``/``record_failure``
      (the cluster store probes with a health op — ``ping`` — before
      risking a real request).
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, config: BreakerConfig | None = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: "Callable[[str, str], None] | None" = None
                 ) -> None:
        self.config = config or BreakerConfig()
        if self.config.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self._clock = clock
        self._on_transition = on_transition
        self._state = self.CLOSED
        self._failures = 0
        self._successes = 0           # consecutive half-open successes
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        # Counters for the metrics plane.
        self.opens = 0
        self.probes = 0

    @property
    def state(self) -> str:
        return self._state

    #: Numeric encoding for gauges: 0 closed, 1 half-open, 2 open.
    _STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def state_gauge(self) -> int:
        return self._STATE_GAUGE[self._state]

    def _transition(self, new: str) -> None:
        old, self._state = self._state, new
        if new == self.OPEN:
            self.opens += 1
            self._opened_at = self._clock()
            self._successes = 0
        elif new == self.CLOSED:
            self._failures = 0
            self._successes = 0
        if self._on_transition is not None and old != new:
            self._on_transition(old, new)

    def quarantined(self) -> bool:
        """True while OPEN inside the recovery window — a NON-consuming
        read (no probe slot is taken), for callers that cannot settle a
        probe (e.g. a blocking peek)."""
        return (self._state == self.OPEN
                and self._clock() - self._opened_at
                < self.config.recovery_timeout_s)

    def allow(self) -> str:
        if self._state == self.CLOSED:
            return "allow"
        if self._state == self.OPEN:
            if (self._clock() - self._opened_at
                    < self.config.recovery_timeout_s):
                return "reject"
            self._transition(self.HALF_OPEN)
            self._probe_inflight = False
        # HALF_OPEN: exactly one probe at a time — a still-down node
        # costs one request per recovery window, never a stampede. An
        # abandoned slot (holder cancelled without settling or calling
        # release_probe) is reclaimed after a recovery window, so a
        # leaked probe can never wedge the node in reject-forever.
        if self._probe_inflight:
            if (self._clock() - self._probe_started
                    < self.config.recovery_timeout_s):
                return "reject"
        self._probe_inflight = True
        self._probe_started = self._clock()
        self.probes += 1
        return "probe"

    def release_probe(self) -> None:
        """Free the half-open probe slot WITHOUT a verdict — for a
        holder cancelled mid-probe. The next ``allow()`` hands the slot
        to someone else. No-op when the slot is not held."""
        self._probe_inflight = False

    def record_success(self) -> None:
        self._probe_inflight = False
        if self._state == self.HALF_OPEN:
            self._successes += 1
            if self._successes >= self.config.half_open_successes:
                self._transition(self.CLOSED)
        elif self._state == self.CLOSED:
            self._failures = 0

    def record_failure(self) -> None:
        self._probe_inflight = False
        if self._state == self.HALF_OPEN:
            self._transition(self.OPEN)
        elif self._state == self.CLOSED:
            self._failures += 1
            if self._failures >= self.config.failure_threshold:
                self._transition(self.OPEN)

    def snapshot(self) -> dict:
        return {
            "state": self._state,
            "failures": self._failures,
            "opens": self.opens,
            "probes": self.probes,
        }
