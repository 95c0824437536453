"""Flight recorder — a bounded ring of recent serving-state frames that
dumps itself to JSONL when things go wrong.

The JAX package's ``utils/flight_recorder.py``, backend-free and kept
whole. An outage diagnosed from prose is an outage whose evidence is gone:
by the time anyone looked, the state that explained the window — flush
sizes and latencies leading in, sync failure streaks, carry growth — was
gone. This module keeps the last N
frames in memory at ~zero cost (one dict append per flush/sync round)
and writes them out the moment a degraded-mode trigger fires, so the
next outage leaves evidence instead of recollection.

Frames are whatever the feeding layer records — the store's flush
observer records ``flush`` frames (batch size, wall time, error), the
tier-0 sync pump records ``t0_sync`` frames (keys drained, shortfall,
failure streak). Triggers: degraded-mode entry (first failure after
healthy operation), a sync-failure streak, or an explicit operator
request (``OP_STATS`` flag bit 1 / the ``/flight`` HTTP path). Automatic
dumps are rate-limited so a flapping trigger cannot fill a disk.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import deque

__all__ = ["FlightRecorder", "REGISTERED_KINDS"]

#: THE frame-kind registry. Every ``record(kind=...)`` call site and
#: every ``frames(kind=...)`` filter must use a kind from this table —
#: drl-check's ``flight-kind`` rule enforces it statically, because a
#: typo'd kind on either side fails SILENTLY (``frames(kind="flsh")``
#: matches nothing and an audit assertion passes vacuously). Add the
#: kind here first, then record it. ``"header"`` is the dump-file
#: header line's own kind.
REGISTERED_KINDS = frozenset({
    "flush",         # store flush observer (runtime/store.py)
    "t0_sync",       # tier-0 sync pump (runtime/native_frontend.py)
    "breaker",       # cluster breaker transitions (runtime/cluster.py)
    "node_error",    # cluster node failures (runtime/cluster.py)
    "controller",    # control-plane actions (runtime/controller.py)
    "reservation",   # reserve/settle events (runtime/reservations.py)
    "federation",    # WAN lease events (runtime/federation.py):
                     # grants/resizes/expiries/heals at the home,
                     # degrade/heal transitions at the region
    "slo",           # burn-rate watchdog alerts (utils/slo.py)
    "audit",         # conservation-ledger breaches (runtime/audit.py)
    "header",        # the dump file's header line
})


class FlightRecorder:
    """Bounded in-memory frame ring with triggered JSONL dumps."""

    def __init__(self, capacity: int = 512,
                 dump_dir: str | None = None,
                 min_dump_interval_s: float = 30.0,
                 name: str = "store") -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._frames: deque[dict] = deque(maxlen=capacity)
        self.capacity = capacity
        self.dump_dir = dump_dir or os.environ.get(
            "DRL_TPU_FLIGHT_DIR") or tempfile.gettempdir()
        self.min_dump_interval_s = min_dump_interval_s
        self.name = name
        self.frames_recorded = 0
        self.dumps_written = 0
        self.dumps_suppressed = 0
        self.last_dump_path: str | None = None
        # None, not 0.0: time.monotonic() counts from boot, so a zero
        # sentinel reads as "dumped at boot" and wrongly suppresses the
        # FIRST automatic dump on any machine whose uptime is still
        # below min_dump_interval_s (a fresh container losing its first
        # — often only — outage capture).
        self._last_dump_mono: float | None = None

    def record(self, kind: str, **fields) -> None:
        """Append one frame. Cheap by design (one dict + deque append);
        called once per flush / sync round, never per request."""
        frame = {"t": time.time(), "mono": time.monotonic(), "kind": kind}
        frame.update(fields)
        self._frames.append(frame)
        self.frames_recorded += 1

    def frames(self, kind: str | tuple[str, ...] | None = None
               ) -> list[dict]:
        """The ring's frames, oldest first; ``kind`` filters to one
        frame kind (e.g. ``"controller"`` — the audit path the control
        plane's action-log assertions read) or, given a tuple, any of
        several kinds (the incident-bundle assembly path pulls
        ``("slo", "audit", "controller")`` in one correlated slice)."""
        if kind is None:
            return list(self._frames)
        if isinstance(kind, tuple):
            wanted = frozenset(kind)
            return [f for f in self._frames if f.get("kind") in wanted]
        return [f for f in self._frames if f.get("kind") == kind]

    def dump(self, reason: str, extra: dict | None = None, *,
             force: bool = True) -> str | None:
        """Write the ring to ``<dump_dir>/flight-<name>-<ts>-<reason>.jsonl``
        (header line first, then frames oldest→newest) and return the
        path. ``force=False`` applies the rate limit — automatic triggers
        use it; explicit operator requests bypass it. Returns ``None``
        when suppressed or the write fails (a full disk must never take
        the serving path down with it)."""
        now = time.monotonic()
        if (not force and self._last_dump_mono is not None
                and now - self._last_dump_mono < self.min_dump_interval_s):
            self.dumps_suppressed += 1
            return None
        safe_reason = "".join(c if c.isalnum() or c in "-_" else "_"
                              for c in reason)[:64]
        path = os.path.join(
            self.dump_dir,
            f"flight-{self.name}-{int(time.time() * 1e3)}-{safe_reason}"
            ".jsonl")
        header = {
            "kind": "header",
            "reason": reason,
            "dumped_at": time.time(),
            "frames": len(self._frames),
            "frames_recorded": self.frames_recorded,
            "capacity": self.capacity,
        }
        if extra:
            header.update(extra)
        try:
            with open(path, "w", encoding="utf-8") as f:
                f.write(json.dumps(header) + "\n")
                for frame in self._frames:
                    f.write(json.dumps(frame, default=repr) + "\n")
        except OSError:
            return None
        self._last_dump_mono = now
        self.dumps_written += 1
        self.last_dump_path = path
        return path

    def auto_dump(self, reason: str, extra: dict | None = None
                  ) -> str | None:
        """Rate-limited trigger for automatic (degraded-mode) dumps."""
        return self.dump(reason, extra, force=False)

    def snapshot(self) -> dict:
        """JSON-shaped status for OP_STATS embedding."""
        return {
            "frames": len(self._frames),
            "frames_recorded": self.frames_recorded,
            "dumps_written": self.dumps_written,
            "dumps_suppressed": self.dumps_suppressed,
            "last_dump_path": self.last_dump_path,
            "dump_dir": self.dump_dir,
        }
