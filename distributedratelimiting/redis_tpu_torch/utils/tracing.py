"""Tracing — the per-command profiling seam and request-scoped spans.

The part of the JAX package's ``utils/tracing.py`` that the micro-batcher
and the store use:

1. The reference's ``ProfilingSession`` seam (StackExchange.Redis): a
   factory returns the session that per-command timings accrue to. Here the
   "commands" are kernel launches — :class:`ProfilingSession` /
   :class:`Profiler` below are that seam.
2. :class:`Tracer`: a :class:`TraceContext` (128-bit trace id, 64-bit span
   id, sampled flag) re-parents the micro-batcher's queue/flush spans and
   the store's launch spans; completed traces land in a bounded buffer,
   tail-sampled (traces ending ``denied``/``queued``/``error``/``degraded``
   or exceeding a latency threshold are always kept).

The default (tracer disabled, no profiling factory) path is
allocation-free: ``span``/``start_span`` return a shared no-op context
manager. Chrome-trace export and device-trace annotations are not ported
yet.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Iterator, NamedTuple

__all__ = [
    "ProfiledCommand",
    "ProfilingSession",
    "Profiler",
    "TraceContext",
    "Span",
    "Tracer",
    "get_tracer",
    "configure",
    "current_context",
]


class ProfiledCommand(NamedTuple):
    """One store dispatch (≙ StackExchange.Redis's ``IProfiledCommand``)."""

    command: str       # e.g. "acquire_batch", "sync_counter", "sweep"
    start_s: float     # time.perf_counter() at dispatch
    duration_s: float  # host wall time of the dispatch (enqueue, not device)
    rows: int          # valid rows in the batch (1 for scalar commands)


class ProfilingSession:
    """Accumulates profiled commands. Thread-safe; drain with
    :meth:`finish` (≙ ``ProfilingSession.FinishProfiling()``)."""

    def __init__(self) -> None:
        self._commands: list[ProfiledCommand] = []
        self._lock = threading.Lock()

    def record(self, cmd: ProfiledCommand) -> None:
        with self._lock:
            self._commands.append(cmd)

    @property
    def commands(self) -> list[ProfiledCommand]:
        with self._lock:
            return list(self._commands)

    def finish(self) -> list[ProfiledCommand]:
        """Return all captured commands and reset the session."""
        with self._lock:
            out = self._commands
            self._commands = []
            return out


# ---------------------------------------------------------------------------
# Trace context + spans
# ---------------------------------------------------------------------------

class TraceContext(NamedTuple):
    """The wire-propagated triple: (trace id, parent span id, flags) —
    the W3C ``traceparent`` shape with the 128-bit trace id split into
    two u64 halves so the wire tail packs as ``<QQQB``. ``flags`` bit 0
    is the head-sampled flag: a downstream hop records its spans for
    this trace regardless of its own coin."""

    trace_hi: int
    trace_lo: int
    span_id: int
    flags: int = 1

    @property
    def sampled(self) -> bool:
        return bool(self.flags & 1)

    @property
    def trace_id(self) -> str:
        return f"{self.trace_hi:016x}{self.trace_lo:016x}"


#: Context variable holding the ambient (innermost open) span of the
#: current task/thread. Spans set it on ``__enter__``; the batcher and
#: wire layers capture it to link work that crosses tasks/threads.
_CURRENT: "ContextVar[Span | None]" = ContextVar("drl_trace_span",
                                                default=None)

#: Span statuses the tail sampler treats as "always keep".
_INTERESTING = frozenset(("denied", "queued", "error", "degraded"))


class Span:
    """One timed node of a trace tree. Context-manager; cheap by design
    (``__slots__``, two ``perf_counter`` reads, one lock append at
    end)."""

    __slots__ = ("_tracer", "name", "trace_hi", "trace_lo", "span_id",
                 "parent_id", "flags", "start_s", "duration_s", "status",
                 "attrs", "_token")

    def __init__(self, tracer: "Tracer", name: str, trace_hi: int,
                 trace_lo: int, span_id: int, parent_id: int,
                 flags: int) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_hi = trace_hi
        self.trace_lo = trace_lo
        self.span_id = span_id
        self.parent_id = parent_id
        self.flags = flags
        self.start_s = time.perf_counter()
        self.duration_s = 0.0
        self.status = "ok"
        self.attrs: dict | None = None
        self._token = None

    @property
    def context(self) -> TraceContext:
        """This span as a wire-propagatable parent reference."""
        return TraceContext(self.trace_hi, self.trace_lo, self.span_id,
                            self.flags)

    def set_status(self, status: str) -> None:
        self.status = status

    def set_attr(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        if exc is not None and self.status == "ok":
            self.status = "error"
            self.set_attr("exception", repr(exc))
        self.end()

    def end(self) -> None:
        self.duration_s = time.perf_counter() - self.start_s
        self._tracer._on_span_end(self)


class _NullSpan:
    """Shared no-op stand-in for :class:`Span` (and the profiler's timed
    span): the untraced path allocates nothing and pays one ``if``."""

    __slots__ = ()

    #: Null spans carry no propagatable context (nothing to stamp on the
    #: wire) — callers test ``span.context is not None``.
    context = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def set_status(self, status: str) -> None:
        return None

    def set_attr(self, key: str, value) -> None:
        return None

    def end(self) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _ActiveTrace:
    """Book-keeping for a trace with locally open spans: completed span
    records plus the open-span refcount that triggers finalization."""

    __slots__ = ("spans", "open", "started_mono")

    def __init__(self) -> None:
        self.spans: list[dict] = []
        self.open = 0
        self.started_mono = time.monotonic()


class Tracer:
    """Span recorder + tail sampler + bounded trace buffer.

    Thread-safe: spans may end on the server loop, the remote client's
    I/O loop, the native pump thread, and blocking callers at once.
    A trace finalizes when its last locally-open span ends (the local
    root — client root in-process, server dispatch span on a remote
    node); late completed spans (the native tier-0 harvest) finalize as
    their own single-span entries and merge by trace id at export.
    """

    def __init__(self, *, enabled: bool = False, sample_rate: float = 1.0,
                 keep_rate: float = 0.1, latency_threshold_s: float = 0.05,
                 max_traces: int = 256, max_active: int = 512,
                 service: str = "drl") -> None:
        self.enabled = enabled
        self.sample_rate = sample_rate
        self.keep_rate = keep_rate
        self.latency_threshold_s = latency_threshold_s
        self.max_traces = max_traces
        self.max_active = max_active
        self.service = service
        self._lock = threading.Lock()
        self._active: dict[tuple[int, int], _ActiveTrace] = {}
        self._finished: deque[dict] = deque(maxlen=max_traces)
        self.spans_recorded = 0
        self.traces_kept = 0
        self.traces_dropped = 0
        self.traces_evicted = 0

    def configure(self, **kw) -> None:
        """Update knobs in place (the module-level :func:`configure`
        mutates the process-global tracer through this)."""
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(f"tracer has no knob {k!r}")
            setattr(self, k, v)
        if "max_traces" in kw:
            with self._lock:
                self._finished = deque(self._finished,
                                       maxlen=self.max_traces)

    # -- span creation ------------------------------------------------------
    def start_span(self, name: str,
                   parent: "TraceContext | Span | None" = None,
                   attrs: dict | None = None) -> "Span | _NullSpan":
        """Open a span. ``parent`` may be an explicit
        :class:`TraceContext` (a wire-decoded remote parent or a context
        captured across threads), a live :class:`Span`, or ``None`` —
        then the ambient span is the parent, and with no ambient span a
        NEW trace starts, subject to the head-sampling coin."""
        if not self.enabled:
            return _NULL_SPAN
        if parent is None:
            parent = _CURRENT.get()
        if parent is None:
            # New trace: the head-sampling coin decides recording; a
            # failed coin is the allocation-free null path end-to-end.
            if self.sample_rate < 1.0 and random.random() >= self.sample_rate:
                return _NULL_SPAN
            hi = random.getrandbits(64) or 1
            lo = random.getrandbits(64) or 1
            span = Span(self, name, hi, lo, random.getrandbits(64) or 1,
                        0, 1)
        else:
            # A live Span and a TraceContext expose the same four
            # fields — one child-construction path serves both.
            span = Span(self, name, parent.trace_hi, parent.trace_lo,
                        random.getrandbits(64) or 1, parent.span_id,
                        parent.flags)
        if attrs:
            span.attrs = dict(attrs)
        key = (span.trace_hi, span.trace_lo)
        with self._lock:
            entry = self._active.get(key)
            if entry is None:
                if len(self._active) >= self.max_active:
                    # Leaked/lost traces must not grow without bound:
                    # evict the stalest active entry.
                    stale = min(self._active,
                                key=lambda k: self._active[k].started_mono)
                    del self._active[stale]
                    self.traces_evicted += 1
                entry = self._active[key] = _ActiveTrace()
            entry.open += 1
        return span

    def record_span(self, name: str, parent: TraceContext,
                    start_s: float, end_s: float, *, status: str = "ok",
                    attrs: dict | None = None) -> None:
        """Add an already-completed span (start/end in ``perf_counter``
        seconds — the same CLOCK_MONOTONIC epoch the native front-end
        stamps). Used for spans reconstructed after the fact: batcher
        queue waits, native tier-0 local decisions harvested from C."""
        if not self.enabled or parent is None:
            return
        rec = {
            "name": name,
            "trace_hi": parent.trace_hi,
            "trace_lo": parent.trace_lo,
            "span_id": random.getrandbits(64) or 1,
            "parent_id": parent.span_id,
            "flags": parent.flags,
            "start_s": start_s,
            "dur_s": max(end_s - start_s, 0.0),
            "status": status,
            "attrs": attrs,
        }
        key = (parent.trace_hi, parent.trace_lo)
        with self._lock:
            self.spans_recorded += 1
            entry = self._active.get(key)
            if entry is not None:
                entry.spans.append(rec)
            else:
                # No locally-open spans for this trace (a late arrival,
                # e.g. the tier-0 harvest on a server that decided the
                # request entirely in C): finalize as its own entry —
                # export merges entries by trace id.
                self._finalize_locked(key, [rec])

    def _on_span_end(self, span: Span) -> None:
        rec = {
            "name": span.name,
            "trace_hi": span.trace_hi,
            "trace_lo": span.trace_lo,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "flags": span.flags,
            "start_s": span.start_s,
            "dur_s": span.duration_s,
            "status": span.status,
            "attrs": span.attrs,
        }
        key = (span.trace_hi, span.trace_lo)
        with self._lock:
            self.spans_recorded += 1
            entry = self._active.get(key)
            if entry is None:  # evicted under pressure: orphan entry
                self._finalize_locked(key, [rec])
                return
            entry.spans.append(rec)
            entry.open -= 1
            if entry.open <= 0:
                del self._active[key]
                self._finalize_locked(key, entry.spans)

    # -- tail sampling ------------------------------------------------------
    def _finalize_locked(self, key: tuple[int, int],
                         spans: list[dict]) -> None:
        # Tail decision (lock held — the checks are O(spans), tiny):
        # interesting outcomes and slow spans are ALWAYS kept; boring
        # traces survive the keep_rate coin. The head coin already gated
        # recording, so this prunes the buffer, not the hot path.
        keep = any(s["status"] in _INTERESTING
                   or s["dur_s"] >= self.latency_threshold_s
                   for s in spans)
        if not keep and self.keep_rate < 1.0:
            keep = random.random() < self.keep_rate
        elif not keep:
            keep = True
        if not keep:
            self.traces_dropped += 1
            return
        self.traces_kept += 1
        self._finished.append({
            "trace_id": f"{key[0]:016x}{key[1]:016x}",
            "spans": spans,
        })

    # -- read-out -----------------------------------------------------------
    def traces(self, drain: bool = False) -> list[dict]:
        """Finished (kept) traces, newest last, entries with one trace id
        merged. ``drain=True`` empties the buffer."""
        with self._lock:
            entries = list(self._finished)
            if drain:
                self._finished.clear()
        merged: dict[str, dict] = {}
        for e in entries:
            tgt = merged.get(e["trace_id"])
            if tgt is None:
                merged[e["trace_id"]] = {"trace_id": e["trace_id"],
                                         "spans": list(e["spans"])}
            else:
                tgt["spans"].extend(e["spans"])
        return list(merged.values())


#: Process-global tracer: every layer references it at call time, so one
#: configure() call turns the whole process's tracing on.
_GLOBAL_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL_TRACER


def configure(**kw) -> Tracer:
    """Configure the process-global tracer (``enabled``, ``sample_rate``,
    ``keep_rate``, ``latency_threshold_s``, ``max_traces`` …) and return
    it."""
    _GLOBAL_TRACER.configure(**kw)
    return _GLOBAL_TRACER


def current_context() -> TraceContext | None:
    """The ambient span's wire-propagatable context (``None`` untraced) —
    what callers capture BEFORE hopping threads/loops, where the context
    variable does not follow."""
    span = _CURRENT.get()
    return None if span is None else span.context


class Profiler:
    """Per-store profiler facade. ``session_factory`` may return ``None``
    to skip recording a given command (the StackExchange contract).
    When the global tracer has an ambient trace, every profiled span is
    ALSO recorded as a child span named ``store.<command>`` — the
    existing dispatch sites double as the kernel-launch layer of the
    distributed trace."""

    __slots__ = ("session_factory",)

    def __init__(
        self,
        session_factory: Callable[[], ProfilingSession | None] | None = None,
    ) -> None:
        self.session_factory = session_factory

    @property
    def enabled(self) -> bool:
        return self.session_factory is not None

    def span(self, command: str, rows: int = 1, *, enabled: bool = True):
        """Context manager timing one dispatch. No-op (shared, allocation
        free) unless a session factory is registered or an ambient trace
        is active. ``enabled=False`` forces the no-op — for inner
        dispatches whose rows an outer span already counted."""
        if not enabled:
            return _NULL_SPAN
        traced = _GLOBAL_TRACER.enabled and _CURRENT.get() is not None
        if self.session_factory is None and not traced:
            return _NULL_SPAN
        return self._timed_span(command, rows, traced)

    @contextmanager
    def _timed_span(self, command: str, rows: int,
                    traced: bool = False) -> Iterator[None]:
        session = self.session_factory() if self.session_factory else None
        tspan = (_GLOBAL_TRACER.start_span(f"store.{command}",
                                           attrs={"rows": rows})
                 if traced else _NULL_SPAN)
        start = time.perf_counter()
        try:
            yield
        except BaseException:
            tspan.set_status("error")
            raise
        finally:
            tspan.end()
            if session is not None:
                session.record(ProfiledCommand(
                    command, start, time.perf_counter() - start, rows,
                ))
