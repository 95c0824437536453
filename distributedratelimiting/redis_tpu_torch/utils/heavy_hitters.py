"""Space-saving top-K sketch — hot-key telemetry for the serving path.

The JAX package's ``utils/heavy_hitters.py``, backend-free (numpy only),
kept whole but for one repair: a read drains a partial ``offer_buffered``
buffer whole (see :meth:`HeavyHitters._drain`), where JAX's merges only
its top ``batch_top`` keys and can cut a heavy key seen once in it. Both
packages' servers report the same top-K for the same stream wherever no
read lands on a partial buffer of more than ``batch_top`` distinct keys.

Which keys dominate admission traffic is the observability input behind
two of the framework's own mechanisms (the tier-0 admission cache hosts
exactly these keys; shard skew is these keys' routing) and the first
question of any rate-limiting incident ("who is being limited?" —
per-tenant visibility is a first-class requirement in the scalable-rate-
limiting literature, PAPERS.md). A full per-key counter table is
unbounded; the space-saving sketch (Metwally et al.) keeps exactly K
monitored keys in O(K) memory with the classic guarantee: any key whose
true count exceeds N/K is monitored, and each reported count overshoots
the true count by at most that entry's recorded ``error``.

Overhead discipline (the <3% serving-plane budget):

- ``offer`` is one dict hit for a monitored key; eviction (unmonitored
  key, full table) finds the minimum through a lazily-repaired heap —
  amortized O(log K), not an O(K) scan (measured: the scan cost
  7.3µs/offer on a cold-tail workload at K=64; the heap ~1.5µs).
- ``offer_buffered`` is the per-request lane's feed: one list append
  (~0.1µs), merged through a C-speed ``Counter`` pass every 1024
  observations (at most ``batch_top`` sketch merges per pass) — the
  sketch lags the stream by at most one buffer (drained whole on every
  read: at most ``buffer_limit`` merges), and the hot path never pays an
  eviction.
- ``offer_many`` batches: one C-speed ``Counter`` pass over the batch,
  then at most ``2·K`` sketch merges regardless of batch size. Keys
  below the per-batch top-2K never reach the sketch — a true heavy
  hitter is by definition in its batches' tops, so the truncation costs
  tail fidelity (which space-saving never promised), not head fidelity.
- ``offer_blob`` feeds the zero-copy bulk lane (``wire.KeyBlob``)
  without materializing per-key strings: a bounded (strided) sample of
  the frame's positive-cost rows is tallied as BYTE slices, only the
  per-frame top ``batch_top`` survivors decode to ``str`` and merge —
  the asyncio bulk analogue of the native lane's per-frame C
  aggregation (frontend.cc ``bulk_hot_feed``). Sampling scales the
  surviving weights by the frame's total, so head weight is preserved
  in expectation while per-frame cost stays O(sample).
- Offers are **cost-weighted** everywhere (an N-token admission weighs
  N): the sketch's counts are TOKENS, which is what makes its top-K the
  hot-*cost* split-candidate feed the resharder consumes
  (``ClusterBucketStore.split_hot_keys``) and the denominator of the
  token-velocity signal (runtime/admission.py).
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Iterable, Sequence

import numpy as np

__all__ = ["HeavyHitters"]


class HeavyHitters:
    """Bounded top-K frequency sketch over string keys."""

    __slots__ = ("k", "batch_top", "_counts", "_errors", "_heap", "_buf",
                 "buffer_limit", "offered")

    def __init__(self, k: int = 64, batch_top: int | None = None,
                 buffer_limit: int = 1024) -> None:
        if k <= 0:
            raise ValueError("k must be positive")
        self.k = k
        #: Per-``offer_many`` merge cap (default 2·K, the space-saving
        #: working-set rule of thumb).
        self.batch_top = batch_top if batch_top is not None else 2 * k
        self._counts: dict[str, float] = {}
        self._errors: dict[str, float] = {}
        # Lazy min-heap of (count, key): increments leave entries
        # stale-LOW (counts only grow), repaired when they surface at
        # the top — one entry per monitored key, so size ≤ K.
        self._heap: list[tuple[float, str]] = []
        # offer_buffered's unit-weight staging list (see module doc).
        self._buf: list[str] = []
        self.buffer_limit = buffer_limit
        #: Total weight offered (the sketch's N — the error bound is N/K).
        self.offered = 0.0

    def __len__(self) -> int:
        self._drain()
        return len(self._counts)

    def _drain(self) -> None:
        """Merge a partial buffer WHOLE, every key of it in
        ``offer_many``'s order. A read (every ``/metrics`` scrape) can land
        anywhere in the stream, so a partial buffer's per-batch top would
        cut a heavy key seen only once or twice in it, and the cut weight
        would never come back; the buffer is bounded by ``buffer_limit``,
        so the merge is too."""
        if self._buf:
            buf = self._buf
            self._buf = []
            for key, c in Counter(buf).most_common():
                self.offer(key, float(c))

    def offer(self, key: str, count: float = 1.0) -> None:
        """Count one observation of ``key`` with weight ``count``."""
        self.offered += count
        counts = self._counts
        if key in counts:
            counts[key] += count  # heap entry goes stale; repaired lazily
            return
        if len(counts) < self.k:
            counts[key] = count
            self._errors[key] = 0.0
            heapq.heappush(self._heap, (count, key))
            return
        # Surface the true minimum: pop/repair stale tops (each repair
        # re-sinks an entry with its current count; every entry is
        # repaired at most once per real increment, so the lazy heap is
        # amortized O(log K) where a dict min-scan was O(K)).
        heap = self._heap
        while True:
            cnt, victim = heap[0]
            actual = counts.get(victim)
            if actual == cnt:
                break
            heapq.heappop(heap)
            if actual is not None:
                heapq.heappush(heap, (actual, victim))
        # Evict it; the newcomer inherits its count as the overestimate
        # bound (the space-saving replacement rule).
        heapq.heappop(heap)
        floor = counts.pop(victim)
        self._errors.pop(victim, None)
        counts[key] = floor + count
        self._errors[key] = floor
        heapq.heappush(heap, (floor + count, key))

    def offer_buffered(self, key: str) -> None:
        """Unit-weight per-request feed: stage the key and merge every
        ``buffer_limit`` observations (one append on the hot path; reads
        drain the buffer first, so nothing is ever lost — only deferred)."""
        buf = self._buf
        buf.append(key)
        if len(buf) >= self.buffer_limit:
            self._buf = []
            self.offer_many(buf)

    def offer_many(self, keys: "Sequence[str] | Iterable[str]",
                   counts: "Sequence[float] | None" = None) -> None:
        """Batch feed: count the batch once at C speed, merge only its
        top ``batch_top`` keys (bounded work per call — see module doc)."""
        if counts is None:
            tally = Counter(keys)
        else:
            tally = Counter()
            for key, c in zip(keys, counts):
                tally[key] += c
        total = float(sum(tally.values()))
        merged = 0.0
        # most_common(k) is heapq.nlargest — O(n log batch_top), no full
        # sort of the batch's unique keys.
        for key, c in tally.most_common(self.batch_top):
            self.offer(key, float(c))
            merged += c
        self.offered += total - merged  # truncated tail still counts in N

    def offer_blob(self, blob: bytes, offsets, counts, *,
                   sample: int = 4096) -> None:
        """Cost-weighted feed straight off a bulk frame's key blob (see
        module doc). ``offsets`` is the ``i64[n+1]`` boundary array of a
        :class:`~.runtime.wire.KeyBlob`; ``counts`` the per-row token
        costs (rows with cost <= 0 — probes — carry no admission
        weight). Bounded work per call: at most ``sample`` byte-slice
        tallies and ``batch_top`` string decodes."""
        counts_np = np.asarray(counts, np.float64)
        n = len(counts_np)
        if n == 0:
            return
        pos = np.nonzero(counts_np > 0)[0]
        if len(pos) == 0:
            return
        total = float(counts_np[pos].sum())
        scale = 1.0
        if len(pos) > sample:
            # Deterministic strided sample (no rng on the serving
            # path); the scale preserves the frame's total weight in
            # expectation — head keys dominate any stride.
            step = -(-len(pos) // sample)
            pos = pos[::step]
            sampled = float(counts_np[pos].sum())
            if sampled <= 0.0:
                return
            scale = total / sampled
        off = np.asarray(offsets, np.int64)
        tally: dict[bytes, float] = {}
        for i in pos.tolist():
            kb = blob[off[i]:off[i + 1]]
            tally[kb] = tally.get(kb, 0.0) + counts_np[i]
        merged = 0.0
        for kb, c in heapq.nlargest(self.batch_top, tally.items(),
                                    key=lambda kv: kv[1]):
            w = c * scale
            self.offer(kb.decode("utf-8", "surrogateescape"), w)
            merged += w
        self.offered += total - merged  # truncated tail still counts in N

    def top(self, n: int | None = None) -> list[tuple[str, float, float]]:
        """``[(key, count, error), ...]`` sorted by count descending.
        ``count`` may overshoot the true count by at most ``error``."""
        self._drain()
        items = sorted(self._counts.items(), key=lambda kv: -kv[1])
        if n is not None:
            items = items[:n]
        return [(k, c, self._errors.get(k, 0.0)) for k, c in items]

    def reset(self) -> None:
        self._counts.clear()
        self._errors.clear()
        self._heap.clear()
        self._buf.clear()
        self.offered = 0.0

    def snapshot(self) -> dict:
        """JSON-shaped summary for OP_STATS embedding."""
        top = self.top(10)  # drains the buffer first
        return {
            "k": self.k,
            "offered": self.offered,
            "tracked": len(self._counts),
            "top": [{"key": k, "count": c, "error": e}
                    for k, c, e in top],
        }
