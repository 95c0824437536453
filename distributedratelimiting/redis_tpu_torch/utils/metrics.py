"""Metrics — decisions, denial rate, batch occupancy, latency.

The per-limiter and per-store counters of the JAX package's
``utils/metrics.py`` that the exact, approximate and queueing limiters and
the store touch. Counters
are plain ints guarded by the GIL (single event loop); latency uses fixed
log-spaced buckets so p50/p99 are O(1) to read and recording is
allocation-free. OpenMetrics exposition is not ported yet.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


class LatencyHistogram:
    """Log-spaced buckets from 1µs to ~70s (factor 1.25, 82 buckets).

    Base 1.25 bounds quantile error at +25% of the true value everywhere
    (a quantile reports its bucket's upper edge), fine enough where the
    <2ms p99 target lives. O(1) memory and allocation-free recording.

    Exemplars: ``record(seconds, trace_id=...)`` (or :meth:`exemplar`)
    attaches the most recent trace id observed per bucket — the jump-off
    from "the p99 moved" to the trace that moved it. Lazy: a histogram
    that never sees a trace id allocates nothing extra."""

    BASE = 1.25
    MIN_S = 1e-6
    N_BUCKETS = 82

    def __init__(self) -> None:
        self.counts = [0] * self.N_BUCKETS
        self.total = 0
        self.sum_s = 0.0  # running sum → mean
        # bucket idx -> (trace_id, observed value, unix ts); None until
        # the first traced observation.
        self.exemplars: dict[int, tuple[str, float, float]] | None = None
        # Measurement-window resets survive reset(): a consumer sharing the
        # window can tell that someone else reset it (OP_STATS
        # ``stats_resets``).
        self.resets = 0

    def reset(self) -> None:
        """Zero in place. Holders keep their reference (the MicroBatcher
        captures the histogram at construction), so a measurement-window
        reset must NOT swap in a fresh object."""
        self.resets += 1
        self.counts = [0] * self.N_BUCKETS
        self.total = 0
        self.sum_s = 0.0
        self.exemplars = None

    def _bucket_index(self, seconds: float) -> int:
        if seconds <= self.MIN_S:
            return 0
        return min(
            self.N_BUCKETS - 1,
            int(math.log(seconds / self.MIN_S, self.BASE)) + 1,
        )

    def record(self, seconds: float, trace_id: str | None = None) -> None:
        idx = self._bucket_index(seconds)
        self.counts[idx] += 1
        self.total += 1
        self.sum_s += seconds
        if trace_id is not None:
            if self.exemplars is None:
                self.exemplars = {}
            self.exemplars[idx] = (trace_id, seconds, time.time())

    def exemplar(self, seconds: float, trace_id: str) -> None:
        """Attach an exemplar WITHOUT counting a sample — for callers
        whose sample is recorded elsewhere with a marginally different
        measurement of the same request (the server's serving span)."""
        if self.exemplars is None:
            self.exemplars = {}
        self.exemplars[self._bucket_index(seconds)] = (
            trace_id, seconds, time.time())

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket containing quantile ``q`` (0..1)."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.MIN_S * (self.BASE ** i)
        return self.MIN_S * (self.BASE ** (self.N_BUCKETS - 1))

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)


@dataclass
class LimiterMetrics:
    """Per-limiter counters. ``snapshot()`` returns a plain dict for export."""

    decisions: int = 0
    grants: int = 0
    denials: int = 0
    queued: int = 0
    evicted: int = 0
    cancelled: int = 0
    sync_failures: int = 0
    syncs: int = 0
    last_sync_lag_s: float = 0.0
    acquire_latency: LatencyHistogram = field(default_factory=LatencyHistogram)

    def record_decision(self, granted: bool, latency_s: float | None = None) -> None:
        self.decisions += 1
        if granted:
            self.grants += 1
        else:
            self.denials += 1
        if latency_s is not None:
            self.acquire_latency.record(latency_s)

    def record_bulk(self, n: int, granted: int,
                    latency_s: float | None = None) -> None:
        """One bulk call = ``n`` decisions; latency recorded once (it is
        the whole call's, not any single request's)."""
        self.decisions += n
        self.grants += granted
        self.denials += n - granted
        if latency_s is not None:
            self.acquire_latency.record(latency_s)

    @property
    def denial_rate(self) -> float:
        return self.denials / self.decisions if self.decisions else 0.0

    def snapshot(self) -> dict:
        return {
            "decisions": self.decisions,
            "grants": self.grants,
            "denials": self.denials,
            "denial_rate": self.denial_rate,
            "queued": self.queued,
            "evicted": self.evicted,
            "cancelled": self.cancelled,
            "syncs": self.syncs,
            "sync_failures": self.sync_failures,
            "last_sync_lag_s": self.last_sync_lag_s,
            "acquire_p50_s": self.acquire_latency.p50,
            "acquire_p99_s": self.acquire_latency.p99,
        }


@dataclass
class StoreMetrics:
    """Per-store (device) counters: kernel launches and batch occupancy."""

    launches: int = 0
    rows_processed: int = 0
    rows_valid: int = 0
    sweeps: int = 0
    slots_evicted: int = 0
    # Duplicate requests merged away by flush coalescing (requests minus
    # launch rows) — the Zipf hot-key win's direct measure.
    rows_coalesced: int = 0
    # Wall time of each micro-batch flush (dispatch + device kernel +
    # readback, measured inside MicroBatcher._run_flush). Serving p99
    # minus flush p99 is the framework's own queueing/fan-out share.
    flush_latency: LatencyHistogram = field(default_factory=LatencyHistogram)
    # Stage 1 of the per-request decomposition: enqueue → flush dispatch,
    # recorded once per flush for the OLDEST request in the batch (its
    # wait upper-bounds every other member's, so this is the conservative
    # envelope of queueing — and costs one perf_counter diff per flush,
    # not per request). serving p99 ≈ queue + flush + reply, each its own
    # scrapeable histogram instead of a bench-time inference.
    queue_latency: LatencyHistogram = field(default_factory=LatencyHistogram)

    def record_launch(self, batch_rows: int, valid_rows: int) -> None:
        self.launches += 1
        self.rows_processed += batch_rows
        self.rows_valid += valid_rows

    @property
    def batch_occupancy(self) -> float:
        return self.rows_valid / self.rows_processed if self.rows_processed else 0.0

    def snapshot(self) -> dict:
        return {
            "launches": self.launches,
            "rows_processed": self.rows_processed,
            "rows_valid": self.rows_valid,
            "batch_occupancy": self.batch_occupancy,
            "sweeps": self.sweeps,
            "slots_evicted": self.slots_evicted,
            "rows_coalesced": self.rows_coalesced,
            "flush_p50_ms": self.flush_latency.p50 * 1e3,
            "flush_p99_ms": self.flush_latency.p99 * 1e3,
            "flush_samples": self.flush_latency.total,
            "queue_p50_ms": self.queue_latency.p50 * 1e3,
            "queue_p99_ms": self.queue_latency.p99 * 1e3,
            "queue_samples": self.queue_latency.total,
        }
