"""Metrics — decisions, denial rate, batch occupancy, latency, exposition.

The per-limiter and per-store counters of the JAX package's
``utils/metrics.py``, and its exposition layer. Counters are plain ints
guarded by the GIL (single event loop); latency uses fixed log-spaced
buckets so p50/p99 are O(1) to read and recording is allocation-free.

:class:`MetricsRegistry` names and namespaces every family (``drl_``
prefix) and renders OpenMetrics text — served by the store server both as
the ``OP_METRICS`` wire op and as a plain HTTP ``/metrics`` endpoint
(``--metrics-port``), byte for byte as the JAX server renders the same
contents, so :func:`aggregate_openmetrics` merges a fleet of either
package's servers. Exposition is pull-only: rendering walks live callables
at scrape time; nothing on the serving path pays for it between scrapes
(a scrape may read the card; a per-request hook never does).

**The destructive-reset contract.** ``stats(reset=True)`` (OP_STATS flag
bit 0) zeroes the server's latency-measurement windows IN PLACE — there is
exactly ONE window per server, shared by every scraper. Two scrapers racing
``reset=True`` silently halve each other's windows. Reset is therefore
reserved for a single operator-driven measurement run (the bench's warm-up
exclusion); automation derives rates with :class:`CounterDeltas` instead:
keep your OWN last-seen snapshot and diff the monotonic counters. Every
histogram counts its resets (:attr:`LatencyHistogram.resets`, surfaced as
``stats_resets`` in OP_STATS) so a consumer can at least DETECT that
someone else tore a window it was relying on.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping


class LatencyHistogram:
    """Log-spaced buckets from 1µs to ~70s (factor 1.25, 82 buckets).

    Base 1.25 bounds quantile error at +25% of the true value everywhere
    (a quantile reports its bucket's upper edge), fine enough where the
    <2ms p99 target lives. O(1) memory and allocation-free recording.

    Exemplars: ``record(seconds, trace_id=...)`` (or :meth:`exemplar`)
    attaches the most recent trace id observed per bucket, rendered as
    OpenMetrics exemplars on the ``_bucket`` series — the jump-off from
    "the p99 moved" to the exact exported trace that moved it. Lazy: a
    histogram that never sees a trace id allocates nothing extra."""

    BASE = 1.25
    MIN_S = 1e-6
    N_BUCKETS = 82

    def __init__(self) -> None:
        self.counts = [0] * self.N_BUCKETS
        self.total = 0
        self.sum_s = 0.0  # running sum → OpenMetrics _sum / mean
        # Measurement-window resets survive reset() by design: the
        # count is the destructive-reset contract's tripwire (module
        # docstring) — a delta-consumer watching it can detect that a
        # concurrent scraper tore the window it was reading.
        self.resets = 0
        # bucket idx -> (trace_id, observed value, unix ts); None until
        # the first traced observation.
        self.exemplars: dict[int, tuple[str, float, float]] | None = None

    def reset(self) -> None:
        """Zero in place. Holders keep their reference (the MicroBatcher
        captures the histogram at construction), so a measurement-window
        reset must NOT swap in a fresh object.

        DESTRUCTIVE for every other consumer of this histogram (module
        docstring): the window is shared, so concurrent scrapers that
        both reset halve each other's measurements. Rate-deriving
        consumers use :class:`CounterDeltas` over the cumulative
        counters instead and never call this."""
        self.counts = [0] * self.N_BUCKETS
        self.total = 0
        self.sum_s = 0.0
        self.resets += 1
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

    @classmethod
    def bucket_upper_bounds(cls) -> list[float]:
        """Upper edge of each bucket in seconds (bucket ``i`` holds samples
        ≤ ``MIN_S·BASE^i``; the last bucket is the overflow catch-all and
        renders as ``+Inf`` in OpenMetrics exposition)."""
        return [cls.MIN_S * (cls.BASE ** i) for i in range(cls.N_BUCKETS)]

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
class Tier0Metrics:
    """Python-side half of the native front-end's tier-0 admission-cache
    observability (the C side counts hits/denies/misses/installs/
    evictions; ``NativeFrontend.tier0_stats`` merges both). Tracks the
    sync pump: reconciliation rounds, degraded-mode failures, and the
    over-admission the saturating debit actually observed — the gauges
    the documented epsilon bound is audited against."""

    syncs: int = 0
    sync_failures: int = 0
    keys_synced: int = 0
    #: Total drained permits that found no tokens (clamped shortfall) —
    #: realized over-admission, to be compared against epsilon.
    overadmit_total: float = 0.0
    #: Largest single-key shortfall seen in any one sync round.
    overadmit_max: float = 0.0
    #: monotonic timestamp of the last successful sync (0 = never) —
    #: ``last_sync_age_s`` in snapshots is the staleness gauge.
    last_sync_mono: float = 0.0
    #: Harvested rows whose (cap, rate) a live config mutation retired
    #: mid-flight: their debits re-routed to the replacement config and
    #: the replica's headroom for the old config was zeroed
    #: (docs/OPERATIONS.md §10).
    retired_config_rows: int = 0

    def record_sync(self, n_keys: int, shortfalls, now_mono: float) -> None:
        self.syncs += 1
        self.keys_synced += n_keys
        if len(shortfalls):
            total = float(sum(shortfalls))
            self.overadmit_total += total
            self.overadmit_max = max(self.overadmit_max,
                                     float(max(shortfalls)))
        self.last_sync_mono = now_mono

    def snapshot(self, now_mono: float) -> dict:
        return {
            "syncs": self.syncs,
            "sync_failures": self.sync_failures,
            "keys_synced": self.keys_synced,
            "overadmit_total": self.overadmit_total,
            "overadmit_max": self.overadmit_max,
            "retired_config_rows": self.retired_config_rows,
            "last_sync_age_s": (now_mono - self.last_sync_mono
                                if self.last_sync_mono else -1.0),
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
    # Table growths (the fingerprint store's doublings).
    pregrows: int = 0
    # Device-resident directory: requests denied because no probe-window
    # cell could be claimed (table pressure — a sweep or a growth follows).
    fp_unresolved: int = 0
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
    # Optional FlightRecorder (utils/flight_recorder.py) fed one frame per
    # flush by the store's flush observer; attached by the serving layer,
    # excluded from snapshot() (not a number).
    flight_recorder: object | None = None

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
            "pregrows": self.pregrows,
            "fp_unresolved": self.fp_unresolved,
            "flush_p50_ms": self.flush_latency.p50 * 1e3,
            "flush_p99_ms": self.flush_latency.p99 * 1e3,
            "flush_samples": self.flush_latency.total,
            "queue_p50_ms": self.queue_latency.p50 * 1e3,
            "queue_p99_ms": self.queue_latency.p99 * 1e3,
            "queue_samples": self.queue_latency.total,
        }


class CounterDeltas:
    """Per-CONSUMER monotonic-counter differ — THE non-destructive way to
    turn cumulative counters into windowed rates (and the guard half of
    the destructive-reset contract in the module docstring).

    Each consumer owns one instance: :meth:`delta` returns the
    non-negative increase of a named counter since *this consumer's*
    previous observation, so any number of scrapers derive rates over
    the same source concurrently without coordinating and without ever
    mutating server state (no ``reset=True``). Counter resets — a
    restarted server reporting a smaller value — restart the window:
    the new value counts as the increase since the reset (the
    Prometheus ``rate()`` convention), never a negative delta.

    Bounded: at ``max_keys`` tracked names the least-recently-observed
    one is forgotten (dynamic series like per-key sketch counts churn;
    a forgotten key's next observation re-anchors at zero delta, which
    only ever under-reports — the conservative direction for every
    consumer this class has)."""

    __slots__ = ("max_keys", "_last")

    def __init__(self, max_keys: int = 8192) -> None:
        if max_keys <= 0:
            raise ValueError("max_keys must be positive")
        self.max_keys = max_keys
        # Insertion order == recency order (moved on every touch).
        self._last: dict[str, float] = {}

    def __len__(self) -> int:
        return len(self._last)

    def delta(self, key: str, value: float) -> float:
        """Increase of counter ``key`` since the previous observation
        (0.0 on the first — the window anchors, it does not report the
        counter's whole lifetime as one burst)."""
        value = float(value)
        last = self._last.pop(key, None)
        if last is None and len(self._last) >= self.max_keys:
            del self._last[next(iter(self._last))]
        self._last[key] = value
        if last is None:
            return 0.0
        if value < last:
            return value  # counter reset: increase since the restart
        return value - last

    def rate(self, key: str, value: float, dt_s: float) -> float:
        """``delta / dt_s`` — the per-second rate over one window."""
        d = self.delta(key, value)
        return d / dt_s if dt_s > 0 else 0.0

    def deltas(self, samples: "Mapping[str, float]") -> dict[str, float]:
        """Vector :meth:`delta` over a ``{name: value}`` snapshot."""
        return {k: self.delta(k, v) for k, v in samples.items()}


# ---------------------------------------------------------------------------
# OpenMetrics exposition
# ---------------------------------------------------------------------------

def _escape_label(value: str) -> str:
    """OpenMetrics label-value escaping: backslash, double-quote, newline."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_labels(labels: "Mapping[str, str] | None") -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def _format_value(v: float) -> str:
    """Compact numeric rendering: integers stay integral, floats use
    repr (full precision — scrapers diff counters, so rounding loses
    information)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 2**53 else repr(f)


class MetricsRegistry:
    """Named metric families rendered as OpenMetrics text exposition.

    Families are registered once with a *callable* that reads the live
    value at scrape time — the registry holds no state of its own, so
    registration costs the serving path nothing and a scrape sees the
    counters exactly as the GIL-guarded writers left them. Three family
    kinds cover everything the framework tracks:

    - ``counter(name, help, fn)`` — monotonically increasing; rendered
      with the OpenMetrics-required ``_total`` sample suffix.
    - ``gauge(name, help, fn)`` — point-in-time value.
    - ``histogram(name, help, fn)`` — ``fn`` returns a
      :class:`LatencyHistogram` (or None to skip); rendered as cumulative
      ``_bucket{le=...}`` series plus ``_count``/``_sum``.

    ``labels`` lets one family carry several series (e.g. per-stage
    latency: ``drl_stage_latency_seconds{stage="queue"}``); register the
    same ``name`` repeatedly with distinct label sets.
    ``register_numeric_dict`` bulk-adopts an existing ``snapshot()``-style
    dict (StoreMetrics, Tier0Metrics, LimiterMetrics) as one gauge/counter
    family per numeric key.
    """

    NAMESPACE = "drl"

    def __init__(self, namespace: str | None = None) -> None:
        self.namespace = namespace if namespace is not None else self.NAMESPACE
        # name -> (type, help); insertion-ordered so exposition is stable.
        self._families: dict[str, tuple[str, str]] = {}
        # (name, labels-tuple, kind, fn) sample sources in registration order.
        self._samples: list[tuple[str, tuple, str, Callable]] = []

    def _full(self, name: str) -> str:
        return f"{self.namespace}_{name}" if self.namespace else name

    def _add(self, name: str, mtype: str, help_text: str,
             fn: Callable, labels: "Mapping[str, str] | None") -> None:
        full = self._full(name)
        prev = self._families.get(full)
        if prev is not None and prev[0] != mtype:
            raise ValueError(
                f"metric {full} already registered as {prev[0]}, "
                f"not {mtype}")
        self._families.setdefault(full, (mtype, help_text))
        self._samples.append(
            (full, tuple((labels or {}).items()), mtype, fn))

    def counter(self, name: str, help_text: str, fn: Callable[[], float],
                labels: "Mapping[str, str] | None" = None) -> None:
        self._add(name, "counter", help_text, fn, labels)

    def gauge(self, name: str, help_text: str, fn: Callable[[], float],
              labels: "Mapping[str, str] | None" = None) -> None:
        self._add(name, "gauge", help_text, fn, labels)

    def histogram(self, name: str, help_text: str,
                  fn: "Callable[[], LatencyHistogram | None]",
                  labels: "Mapping[str, str] | None" = None) -> None:
        self._add(name, "histogram", help_text, fn, labels)

    def labeled_gauges(self, name: str, help_text: str,
                       fn: "Callable[[], Iterable[tuple[dict, float]]]"
                       ) -> None:
        """One gauge family whose SERIES SET is dynamic at scrape time —
        ``fn`` yields ``(labels_dict, value)`` pairs (the heavy-hitter
        top-K, whose keys change between scrapes)."""
        self._add(name, "gauge", help_text, fn, {"__dynamic__": "1"})

    def labeled_counters(self, name: str, help_text: str,
                         fn: "Callable[[], Iterable[tuple[dict, float]]]"
                         ) -> None:
        """Counter twin of :meth:`labeled_gauges`: a dynamic series set
        rendered with the OpenMetrics-required ``_total`` sample suffix
        (e.g. the controller's
        ``drl_controller_actions_total{action=,outcome=}`` family)."""
        self._add(name, "counter", help_text, fn, {"__dynamic__": "1"})

    def register_numeric_dict(self, prefix: str, help_prefix: str,
                              fn: "Callable[[], Mapping | None]",
                              counters: "set[str] | frozenset[str]" = frozenset(),
                              labels: "Mapping[str, str] | None" = None
                              ) -> None:
        """Adopt a ``snapshot()``-style dict wholesale: every numeric key
        becomes ``<prefix>_<key>`` (counter when named in ``counters``,
        gauge otherwise; non-numeric and nested values are skipped). The
        key set is re-read per scrape, so optional keys (e.g. tier-0 off)
        simply don't render."""

        def emit():
            d = fn()
            if not d:
                return []
            out = []
            for k, v in d.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                out.append((k, float(v)))
            return out

        # Registered as one dynamic family per numeric key at scrape time:
        # store under a sentinel so render() expands names per key.
        full = self._full(prefix)
        self._families.setdefault(full, ("dict", help_prefix))
        self._samples.append(
            (full, tuple((labels or {}).items()) + (
                ("__counters__", frozenset(counters)),), "dict", emit))

    # -- rendering -----------------------------------------------------------
    CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8")

    def render(self, exemplars: bool = True) -> str:
        """The full OpenMetrics text exposition, terminated by ``# EOF``.
        ``exemplars=False`` suppresses exemplar annotations — for the
        Prometheus text-0.0.4 fallback the HTTP listener serves to
        scrapers that did not ``Accept`` openmetrics (exemplars are an
        OpenMetrics-only construct)."""
        lines: list[str] = []
        seen_type: set[str] = set()

        def type_line(name: str, mtype: str, help_text: str) -> None:
            if name in seen_type:
                return
            seen_type.add(name)
            lines.append(f"# TYPE {name} {mtype}")
            if help_text:
                lines.append(f"# HELP {name} {_escape_label(help_text)}")

        for full, labels_t, kind, fn in self._samples:
            mtype, help_text = self._families[full]
            if kind == "dict":
                labels = dict(labels_t)
                counters = labels.pop("__counters__", frozenset())
                try:
                    items = fn()
                except Exception:
                    continue  # a broken reader must not kill the scrape
                lbl = _format_labels(labels)
                for key, value in items:
                    name = f"{full}_{key}"
                    is_counter = key in counters
                    type_line(name, "counter" if is_counter else "gauge",
                              help_text and f"{help_text}: {key}")
                    suffix = "_total" if is_counter else ""
                    lines.append(
                        f"{name}{suffix}{lbl} {_format_value(value)}")
                continue
            labels = dict(labels_t)
            dynamic = labels.pop("__dynamic__", None)
            try:
                value = fn()
            except Exception:
                continue
            type_line(full, mtype, help_text)
            if dynamic:
                suffix = "_total" if mtype == "counter" else ""
                for series_labels, v in value:
                    lines.append(f"{full}{suffix}"
                                 f"{_format_labels(series_labels)} "
                                 f"{_format_value(v)}")
            elif mtype == "histogram":
                if value is None:
                    continue
                self._render_histogram(lines, full, labels, value,
                                       exemplars)
            else:
                if value is None:
                    continue
                suffix = "_total" if mtype == "counter" else ""
                lines.append(f"{full}{suffix}{_format_labels(labels)} "
                             f"{_format_value(value)}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    @staticmethod
    def _render_histogram(lines: list[str], full: str, labels: dict,
                          hist: LatencyHistogram,
                          exemplars: bool = True) -> None:
        bounds = hist.bucket_upper_bounds()
        ex = hist.exemplars if exemplars else None
        cum = 0
        for i, c in enumerate(hist.counts):
            cum += c
            if (c == 0 and i < len(hist.counts) - 1
                    and (ex is None or i not in ex)):
                continue  # sparse: only emit buckets that move the cdf
            le = ("+Inf" if i == len(hist.counts) - 1
                  else repr(bounds[i]))
            lbl = _format_labels({**labels, "le": le})
            line = f"{full}_bucket{lbl} {cum}"
            if ex is not None and i in ex:
                # OpenMetrics exemplar: `value # {labels} ex_value ex_ts`
                tid, val, ts = ex[i]
                line += (f' # {{trace_id="{_escape_label(tid)}"}} '
                         f"{_format_value(val)} {round(ts, 3)}")
            lines.append(line)
        lbl = _format_labels(labels)
        lines.append(f"{full}_count{lbl} {hist.total}")
        lines.append(f"{full}_sum{lbl} {_format_value(hist.sum_s)}")


def parse_openmetrics(text: str) -> tuple[dict[str, str],
                                          list[tuple[str, tuple, float]]]:
    """Minimal OpenMetrics parser for aggregation: returns
    ``(types_by_name, samples)`` where each sample is
    ``(sample_name, ((label, value), ...), float)``. Handles the subset
    :class:`MetricsRegistry` emits (exemplar annotations are stripped;
    timestamps are not emitted)."""
    types: dict[str, str] = {}
    samples: list[tuple[str, tuple, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line == "# EOF":
            continue
        # Exemplars ride after ` # {...}` on bucket lines — aggregation
        # sums sample values, so they drop here (quote-aware: a label
        # VALUE may legitimately contain " # ").
        if not line.startswith("#"):
            line = _strip_exemplar(line)
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            lbl_text, _, val_text = rest.rpartition("}")
            labels = []
            for piece in _split_labels(lbl_text):
                k, _, v = piece.partition("=")
                labels.append((k, _unescape_label(v.strip('"'))))
            labels_t = tuple(labels)
        else:
            name, _, val_text = line.rpartition(" ")
            labels_t = ()
        try:
            samples.append((name.strip(), labels_t, float(val_text)))
        except ValueError:
            continue
    return types, samples


def _strip_exemplar(line: str) -> str:
    """Drop a sample line's exemplar annotation (`` # {...} val ts``).
    The split must happen AFTER the label set's closing brace — label
    values are user-controlled (hot keys) and may contain ``\" # \"``
    themselves — so the label block is skipped with the same
    quote/escape rules :func:`_split_labels` uses."""
    start = 0
    brace = line.find("{")
    space = line.find(" ")
    if brace != -1 and (space == -1 or brace < space):
        in_q = esc = False
        for i in range(brace + 1, len(line)):
            ch = line[i]
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_q = not in_q
            elif ch == "}" and not in_q:
                start = i + 1
                break
        else:
            return line  # unterminated label set: leave as-is
    cut = line.find(" # ", start)
    return line[:cut].rstrip() if cut != -1 else line


def _split_labels(text: str) -> list[str]:
    """Split ``a="x",b="y"`` on commas outside quotes."""
    out, buf, in_q, esc = [], [], False, False
    for ch in text:
        if esc:
            buf.append(ch)
            esc = False
            continue
        if ch == "\\":
            buf.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
            buf.append(ch)
            continue
        if ch == "," and not in_q:
            out.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        out.append("".join(buf))
    return out


def _unescape_label(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def aggregate_openmetrics(node_texts: "Iterable[str]",
                          node_label: str = "node") -> str:
    """Merge N nodes' OpenMetrics expositions into one: every sample is
    re-emitted per node with a ``node="<i>"`` label, and samples that sum
    meaningfully (counters, histogram ``_bucket``/``_count``/``_sum``, and
    additive gauges) also get an aggregated series without the node label.
    Non-additive gauges (rates, quantile gauges) aggregate as sums too —
    consumers who care read the per-node series; the summed series is the
    fleet-roll-up convention (the same one ``ClusterBucketStore.stats``
    already uses for its JSON totals). Output is grouped per family (one
    ``# TYPE`` line, then that family's aggregated + per-node samples,
    contiguously) — OpenMetrics forbids interleaving a family's samples
    with another's, and compliant scrapers enforce it."""
    agg: dict[tuple[str, tuple], float] = {}
    agg_order: list[tuple[str, tuple]] = []
    per_node: dict[str, list[str]] = {}  # family -> per-node sample lines
    types: dict[str, str] = {}
    fam_order: list[str] = []

    def base_family(sample_name: str) -> str:
        for suffix in ("_bucket", "_count", "_sum", "_total"):
            if sample_name.endswith(suffix):
                root = sample_name[: -len(suffix)]
                if root in types:
                    return root
        return sample_name

    for i, text in enumerate(node_texts):
        node_types, samples = parse_openmetrics(text)
        types.update(node_types)
        for name, labels_t, value in samples:
            key = (name, labels_t)
            if key not in agg:
                agg[key] = 0.0
                agg_order.append(key)
            agg[key] += value
            fam = base_family(name)
            if fam not in per_node:
                per_node[fam] = []
                fam_order.append(fam)
            lbl = _format_labels(dict(labels_t) | {node_label: str(i)})
            per_node[fam].append(f"{name}{lbl} {_format_value(value)}")
    agg_by_family: dict[str, list[str]] = {}
    for name, labels_t in agg_order:
        fam = base_family(name)
        agg_by_family.setdefault(fam, []).append(
            f"{name}{_format_labels(dict(labels_t))} "
            f"{_format_value(agg[(name, labels_t)])}")
    lines: list[str] = []
    for fam in fam_order:
        if fam in types:
            lines.append(f"# TYPE {fam} {types[fam]}")
        lines.extend(agg_by_family.get(fam, []))
        lines.extend(per_node[fam])
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
