"""Resilience primitives: the retry policy with jittered backoff.

The part of the JAX package's ``utils/resilience.py`` that the remote
client needs. Naive synchronized retries are how rate limiters melt their
own backends: a fleet of clients that all retry at t+1s is a thundering
herd with a timer. Full jitter on the top half of the delay decorrelates
them. The policy object is pure (delay computation only); WHO may retry
WHAT is the caller's contract — see the at-most-once rules in
``runtime/remote.py``. Free of I/O and asyncio, so it is deterministic
under a seeded ``random.Random``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

__all__ = ["RetryPolicy"]


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
