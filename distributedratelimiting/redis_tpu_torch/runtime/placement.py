"""Epoch-versioned keyspace placement and live migration — the cluster's
ownership map, on the port.

The JAX package's ``runtime/placement.py`` with its names and ``__all__``.
The keyspace is split into ``n_slots`` fixed slots (``slot = crc32(key) %
n_slots``, the same stable crc32 the mesh routes shards by:
:func:`~..parallel.sharded_store.shard_of_key`). A membership change
reassigns *slots*, not the hash function, so only the moved slots' keys
re-home. The map is **epoch-versioned**: nodes adopt maps monotonically (a
stale announce is a typed error) and clients learn new epochs from a
``placement moved`` error and a refetch. A single key may carry an
*override* pinning it to a node regardless of its slot.
:meth:`PlacementMap.initial` assigns slot ``s`` to node ``s % N`` over ``N
× slots_per_node`` slots, so epoch-0 routing equals ``crc32 % N``.

Live migration ships bucket state along with ownership: the export below
normalizes any store's :meth:`snapshot` (host dict or card slot arrays)
into flat per-key entries, and the *generic* import lane replays them
through the saturating debit (``debit_many``: ``debit_packed`` on the
card), so a card store adopts migrated balances with no snapshot surgery;
the serial store takes its exact merge lane. Checkpoints carry the
placement epoch (:mod:`~.checkpoint`).

**The dual-ownership bound.** During an ownership transfer two nodes
serving the same key independently would double-admit ("When Two is Worse
Than One", PAPERS.md). The handoff window *partitions the budget* instead:
at PULL time the old owner debits every exported bucket by a fair-share
envelope (:func:`~..models.approximate.headroom_budget`) and serves the
parked keys **only from that envelope** for a bounded ``window_s``; the
new owner imports the debited remainder, and the old owner's own store is
charged the shipped amount at the same instant (:func:`debit_source`), so
its authoritative residual IS the envelope. Old + new together never admit
more than the original balance plus one envelope per key per episode, in
every termination order: commit, coordinator abort (the old owner serves
again from its residual), and window expiry (the old owner auto-aborts).

Two differences from the JAX module. The generic lane replays a section's
windows, counters and semaphores concurrently (one ``asyncio.gather`` a
section) where JAX awaits them row by row. An export holds each entry once
(a key under one configuration), so the rows are independent and the
state after is the same; the store's micro-batcher decides them in
flushes of up to ``max_batch`` rows instead of one launch a row. And a
pull parks its slots before it exports them, where JAX parks after the
export: traffic on a moved key while the export runs (seconds on a
10M-key card store) is served from the envelope, not from the full
balance that ships as well, so the bound above holds for it too. The
handoff window opens once the export is cached, as in JAX.
"""

from __future__ import annotations

import asyncio
import json
import math
import time
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from distributedratelimiting.redis_tpu_torch.models.approximate import (
    headroom_budget,
)
from distributedratelimiting.redis_tpu_torch.ops import bucket_math
from distributedratelimiting.redis_tpu_torch.parallel.sharded_store import (
    route_keys,
    shard_of_key,
)
from distributedratelimiting.redis_tpu_torch.runtime import wire

__all__ = [
    "PlacementMap", "NodePlacementState", "StalePlacementError",
    "PlacementError", "extract_entries", "entry_count",
    "split_entries", "chunk_entries", "debit_source",
    "DEFAULT_SLOTS_PER_NODE", "DEFAULT_ENVELOPE_FRACTION",
    "MOVED_ERROR_PREFIX", "HANDOFF_DEFERRAL_PREFIX",
]

#: Epoch-0 slots per node. The initial map's ``n_slots = N × this`` with
#: slot ``s → s % N`` reproduces ``crc32 % N`` exactly (``crc32 % kN % N
#: == crc32 % N``), and 16 slots/node keeps single-slot moves ≤ ~6% of a
#: node's keyspace — the rebalance granularity.
DEFAULT_SLOTS_PER_NODE = 16

#: Stable prefix of the routable "wrong owner" error — clients detect it
#: with a substring match (the trace/deadline "unknown op" latch posture)
#: and refetch the map instead of failing the caller.
MOVED_ERROR_PREFIX = "placement moved"

#: Stable prefix of the transient "parked mid-handoff, no envelope
#: value" error (PEEK/SYNC/SEMA on a parked key). A healthy node answers
#: it for at most one handoff window — clients must treat it as
#: retryable, never as node failure (breakers exempt it).
HANDOFF_DEFERRAL_PREFIX = "placement handoff in progress"

#: The envelope a parked key's admission serves from, by scalar op and by
#: bulk kind. A gated op with none (PEEK, SYNC, SEMA) answers the handoff
#: deferral instead.
ENVELOPE_KIND = {wire.OP_ACQUIRE: "bucket", wire.OP_WINDOW: "window",
                 wire.OP_FWINDOW: "fwindow"}
BULK_ENVELOPE_KIND = {wire.BULK_KIND_BUCKET: "bucket",
                      wire.BULK_KIND_WINDOW: "window",
                      wire.BULK_KIND_FWINDOW: "fwindow"}

#: Fair-share fraction of the handoff envelope — the same default as the
#: cluster's degraded fallback (one confidence policy family).
DEFAULT_ENVELOPE_FRACTION = 0.5


class PlacementError(RuntimeError):
    """Membership/migration control-plane failure (health gate, state
    push, commit) — the migration aborted cleanly to the old epoch."""


class StalePlacementError(PlacementError):
    """The announced/requested epoch is older than what this node has
    already adopted (epochs are monotonic; re-announcing the current
    epoch is idempotent, announcing an older one is a protocol error)."""


#: The slot of a key: the mesh's shard hash, one crc32 family for in-mesh
#: shards, cluster slots and the native router.
_slot_of = shard_of_key


def keep_predicate(n_slots: int, overrides: Mapping,
                   slots: "frozenset[int] | set[int]",
                   keys: "frozenset[str] | set[str] | None"
                   ) -> Callable[[str], bool]:
    """THE ownership-transfer selection rule, shared by the server-side
    pull and the cluster's in-process lane: the union of the named keys
    and the slot set — a drain moves both its slots AND any override
    pinned here. Override keys route independently of their slot (the
    gate's rule), so a slot move never drags a pinned key's state
    along."""
    def keep(k: str) -> bool:
        if keys and k in keys:
            return True
        return k not in overrides and _slot_of(k, n_slots) in slots
    return keep


class PlacementMap:
    """Immutable epoch-versioned ``slot → node`` map plus per-key
    overrides. Mutation = :meth:`with_assignments` → a new map at
    ``epoch + 1`` (nodes and clients compare epochs, never diffs)."""

    __slots__ = ("epoch", "n_slots", "slot_owner", "overrides",
                 "_override_slot_cache")

    def __init__(self, epoch: int, slot_owner: "Sequence[int] | np.ndarray",
                 overrides: "Mapping[str, int] | None" = None) -> None:
        self.epoch = int(epoch)
        self.slot_owner = np.ascontiguousarray(slot_owner, np.int32)
        self.n_slots = int(len(self.slot_owner))
        if self.n_slots == 0:
            raise ValueError("placement map needs at least one slot")
        self.overrides: dict[str, int] = dict(overrides or {})
        self._override_slot_cache: "np.ndarray | None" = None

    def override_slots(self) -> np.ndarray:
        """Sorted slots the override keys hash into — the bulk lanes'
        prefilter: rows outside these slots can skip the per-key
        override probe entirely (the map is immutable, so this is
        computed once)."""
        cache = self._override_slot_cache
        if cache is None:
            cache = np.unique(np.fromiter(
                (_slot_of(k, self.n_slots) for k in self.overrides),
                np.int64, len(self.overrides)))
            self._override_slot_cache = cache
        return cache

    @classmethod
    def initial(cls, n_nodes: int,
                slots_per_node: int = DEFAULT_SLOTS_PER_NODE
                ) -> "PlacementMap":
        """Epoch-0 map whose routing is bit-identical to the legacy
        ``crc32(key) % n_nodes`` (see module docstring)."""
        if n_nodes < 1:
            raise ValueError("placement needs at least one node")
        n_slots = n_nodes * slots_per_node
        return cls(0, np.arange(n_slots, dtype=np.int32) % n_nodes)

    # -- routing -------------------------------------------------------------
    def slot_of(self, key: str) -> int:
        return _slot_of(key, self.n_slots)

    def node_of(self, key: str) -> int:
        ov = self.overrides.get(key)
        if ov is not None:
            return ov
        return int(self.slot_owner[_slot_of(key, self.n_slots)])

    def route(self, keys: Sequence[str]) -> np.ndarray:
        """Vectorized :meth:`node_of` over a batch — one native crc32
        pass (``route_keys``; KeyBlob-aware) plus a table take; override
        fix-up only runs when overrides exist (they are few by design)."""
        slots = route_keys(keys, self.n_slots)
        owners = self.slot_owner[slots].astype(np.int64)
        if self.overrides:
            # Prefilter by slot: only rows that hash into an override
            # key's slot pay the per-key probe — one vectorized isin
            # keeps the zero-copy bulk lane zero-copy for every other
            # row no matter how long the override table lives.
            cand = np.isin(slots, self.override_slots())
            if cand.any():
                ov = self.overrides
                for i in np.nonzero(cand)[0]:
                    j = ov.get(keys[int(i)])
                    if j is not None:
                        owners[i] = j
        return owners

    # -- introspection -------------------------------------------------------
    def owned_slots(self, node: int) -> np.ndarray:
        return np.nonzero(self.slot_owner == node)[0].astype(np.int32)

    def slot_counts(self, n_nodes: int) -> np.ndarray:
        return np.bincount(self.slot_owner, minlength=n_nodes)

    def nodes_in_use(self) -> set[int]:
        used = set(np.unique(self.slot_owner).tolist())
        used.update(self.overrides.values())
        return {int(j) for j in used}

    # -- evolution -----------------------------------------------------------
    def with_assignments(self, moves: "Mapping[int, int] | None" = None,
                         set_overrides: "Mapping[str, int] | None" = None,
                         drop_overrides: "Iterable[str] | None" = None
                         ) -> "PlacementMap":
        """The next epoch: reassign ``moves`` (slot → new owner), add
        ``set_overrides`` (key → node pins), drop ``drop_overrides``."""
        owner = self.slot_owner.copy()
        for slot, node in (moves or {}).items():
            if not 0 <= slot < self.n_slots:
                raise ValueError(f"slot {slot} out of range")
            owner[slot] = node
        ov = dict(self.overrides)
        for k in drop_overrides or ():
            ov.pop(k, None)
        ov.update(set_overrides or {})
        return PlacementMap(self.epoch + 1, owner, ov)

    def rebalance_moves(self, active: Sequence[int]) -> dict[int, int]:
        """Deterministic plan evening slot counts over ``active`` nodes:
        slots leave over-target nodes (and every inactive node) in
        ascending slot order and land on the most-underfilled active
        node. Empty plan = already balanced."""
        active = sorted(set(int(j) for j in active))
        if not active:
            raise ValueError("rebalance needs at least one active node")
        base, extra = divmod(self.n_slots, len(active))
        target = {j: base + (1 if i < extra else 0)
                  for i, j in enumerate(active)}
        have: dict[int, int] = {j: 0 for j in active}
        for s in self.slot_owner.tolist():
            if s in have:
                have[s] += 1
        moves: dict[int, int] = {}
        deficit = {j: target[j] - have[j] for j in active}
        receivers = [j for j in active if deficit[j] > 0]
        if not receivers:
            return {}
        ri = 0
        for slot in range(self.n_slots):
            owner = int(self.slot_owner[slot])
            give = owner not in target or have[owner] > target[owner]
            if not give:
                continue
            while ri < len(receivers) and deficit[receivers[ri]] <= 0:
                ri += 1
            if ri >= len(receivers):
                break
            dst = receivers[ri]
            moves[slot] = dst
            deficit[dst] -= 1
            if owner in have:
                have[owner] -= 1
        return moves

    # -- codec ---------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "n_slots": self.n_slots,
                "slot_owner": self.slot_owner.tolist(),
                "overrides": dict(self.overrides)}

    @classmethod
    def from_dict(cls, data: Mapping) -> "PlacementMap":
        m = cls(data["epoch"], data["slot_owner"],
                data.get("overrides") or {})
        if m.n_slots != data.get("n_slots", m.n_slots):
            raise ValueError("placement map n_slots disagrees with its "
                             "slot_owner table")
        return m

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, text: str) -> "PlacementMap":
        return cls.from_dict(json.loads(text))

    def __eq__(self, other) -> bool:
        return (isinstance(other, PlacementMap)
                and self.epoch == other.epoch
                and np.array_equal(self.slot_owner, other.slot_owner)
                and self.overrides == other.overrides)

    def __repr__(self) -> str:
        return (f"PlacementMap(epoch={self.epoch}, n_slots={self.n_slots},"
                f" nodes={sorted(self.nodes_in_use())},"
                f" overrides={len(self.overrides)})")


# -- normalized state entries (the handoff payload) --------------------------
#
# One schema-free form for "a key's limiter state", JSON-safe so it rides
# RESP_TEXT migration frames:
#
#   {"buckets":  [[key, capacity, rate_per_sec, tokens, age_ticks], …],
#    "windows":  [[key, limit, wt_ticks, interp, prev, curr, idx_behind], …],
#    "counters": [[key, value, period, age_ticks], …],
#    "semas":    [[key, active], …]}
#
# Timestamps travel as AGES relative to the exporting snapshot's clock
# (``now_ticks − ts``) — the two processes' clock epochs never compare
# (invariant 1); the importer re-anchors against its own now.

#: ``reservations`` rows are the estimate-reserve-settle ledger's
#: outstanding holds (``[tenant, rid, key, reserved, a, b, ta, tb,
#: priority, ttl_remaining_s]`` — row[0] is the TENANT because that is
#: the routing identity hierarchical traffic and its settles follow);
#: ``debts`` rows are ``[tenant, amount, export_tag]``. Both ride the same
#: chunk/dedup/push machinery as bucket state; an old importer simply
#: ignores the unknown sections (the reserved tokens stay debited and
#: unrefunded — under-admission, the safe direction).
_EMPTY_ENTRIES = {"buckets": [], "windows": [], "counters": [],
                  "semas": [], "reservations": [], "debts": []}


def entry_count(entries: Mapping) -> int:
    return sum(len(entries.get(k, ())) for k in _EMPTY_ENTRIES)


def extract_entries(snap: Mapping, keep: Callable[[str], bool]) -> dict:
    """Filter a store snapshot down to the keys ``keep`` selects, in the
    normalized entry form. Understands both snapshot schemas in-tree:
    the host-dict form (:class:`~.store.InProcessBucketStore`) and the
    device slot-array form (:class:`~.store.DeviceBucketStore` — per-
    table key directory + SoA arrays)."""
    if "buckets" not in snap and "tables" not in snap:
        # Unknown schema must fail LOUDLY: an empty export would commit
        # a migration that silently dropped the keyspace's state (the
        # coordinator's abort path exists exactly for this).
        raise ValueError(
            "unrecognized snapshot schema (neither host-dict 'buckets' "
            "nor device 'tables'); this store cannot export handoff "
            "entries")
    now = int(snap["now_ticks"])
    out = {k: [] for k in _EMPTY_ENTRIES}
    if "buckets" in snap:  # host-dict schema
        for (key, cap, rate), (tokens, ts) in snap["buckets"].items():
            if keep(key):
                out["buckets"].append(
                    [key, float(cap), float(rate), float(tokens),
                     now - int(ts)])
        for (key, limit, wt, interp), (prev, curr, idx) in \
                snap.get("windows", {}).items():
            if keep(key):
                out["windows"].append(
                    [key, float(limit), int(wt), int(bool(interp)),
                     float(prev), float(curr), now // int(wt) - int(idx)])
        for key, (v, p, ts) in snap.get("counters", {}).items():
            if keep(key):
                out["counters"].append(
                    [key, float(v), float(p), now - int(ts)])
        for key, active in snap.get("semas", {}).items():
            if keep(key) and active:
                out["semas"].append([key, int(active)])
        return out
    # device slot-array schema
    for (cap, rate), t in snap.get("tables", {}).items():
        tokens, last_ts = np.asarray(t["tokens"]), np.asarray(t["last_ts"])
        exists = np.asarray(t["exists"])
        for key, slot in t["directory"].items():
            if exists[slot] and keep(key):
                out["buckets"].append(
                    [key, float(cap), float(rate), float(tokens[slot]),
                     now - int(last_ts[slot])])
    for (limit, wt, fixed), t in snap.get("wtables", {}).items():
        prev, curr = np.asarray(t["prev_count"]), np.asarray(t["curr_count"])
        idx, exists = np.asarray(t["window_idx"]), np.asarray(t["exists"])
        for key, slot in t["directory"].items():
            if exists[slot] and keep(key):
                out["windows"].append(
                    [key, float(limit), int(wt), int(not fixed),
                     float(prev[slot]), float(curr[slot]),
                     now // int(wt) - int(idx[slot])])
    c = snap.get("counters")
    if isinstance(c, dict) and "value" in c:
        value, period = np.asarray(c["value"]), np.asarray(c["period"])
        last_ts, exists = np.asarray(c["last_ts"]), np.asarray(c["exists"])
        for key, slot in snap.get("counter_dir", {}).items():
            if exists[slot] and keep(key):
                out["counters"].append(
                    [key, float(value[slot]), float(period[slot]),
                     now - int(last_ts[slot])])
    s = snap.get("semas")
    if isinstance(s, dict) and "active" in s:
        active, exists = np.asarray(s["active"]), np.asarray(s["exists"])
        for key, slot in snap.get("sema_dir", {}).items():
            if exists[slot] and keep(key) and int(active[slot]):
                out["semas"].append([key, int(active[slot])])
    return out


def split_entries(entries: Mapping, owner_of: Callable[[str], int]
                  ) -> dict[int, dict]:
    """Partition one export by destination node (a drain fans one pull
    out to several new owners)."""
    out: dict[int, dict] = {}
    for section in _EMPTY_ENTRIES:
        for row in entries.get(section, ()):
            dst = owner_of(row[0])
            out.setdefault(dst, {k: [] for k in _EMPTY_ENTRIES})[
                section].append(row)
    return out


#: Per-chunk serialized-size budget: well under wire.MAX_FRAME (1 MiB)
#: after JSON framing + the push envelope. Rows are bounded by BOTH this
#: and ``max_rows`` — long keys (up to 64 KiB on the keyed lane) must
#: not produce a chunk no frame can carry.
_CHUNK_BYTE_BUDGET = 700_000
#: JSON overhead per row beyond the key text (brackets, numbers, commas).
_ROW_OVERHEAD = 96


def chunk_entries(entries: Mapping, max_rows: int = 4096) -> list[dict]:
    """Split an export into batches bounded by row count AND serialized
    size, so every MIGRATE_PUSH frame fits MAX_FRAME regardless of key
    length. Each chunk carries its own batch id slot-in (the receiver's
    exactly-once dedup unit)."""
    chunks: list[dict] = []
    cur = {k: [] for k in _EMPTY_ENTRIES}
    n = 0
    size = 0
    for section in _EMPTY_ENTRIES:
        for row in entries.get(section, ()):
            # Size EVERY string field as it will actually serialize:
            # ensure_ascii JSON expands every non-ASCII / surrogate-
            # escaped char to a 6-byte \uXXXX escape, so a 60 KiB
            # hostile key can be ~6x its character count on the wire —
            # and reservation rows carry rid + child key at positions
            # 1-2 beyond the tenant at row[0], so sizing row[0] alone
            # would let a chunk of long-keyed reservations blow past
            # MAX_FRAME.
            row_size = sum(len(json.dumps(v)) for v in row
                           if isinstance(v, str)) + _ROW_OVERHEAD
            if n and (n >= max_rows
                      or size + row_size > _CHUNK_BYTE_BUDGET):
                chunks.append(cur)
                cur = {k: [] for k in _EMPTY_ENTRIES}
                n = 0
                size = 0
            cur[section].append(row)
            n += 1
            size += row_size
    if n or not chunks:
        chunks.append(cur)
    return chunks


def merge_entries(a: Mapping, b: Mapping) -> dict:
    """Concatenate two entry batches section-wise (the client half of a
    paged pull: pages reassemble into the one export they were chunked
    from)."""
    out = {k: list(a.get(k, ())) for k in _EMPTY_ENTRIES}
    for k in _EMPTY_ENTRIES:
        out[k].extend(b.get(k, ()))
    return out


async def saturating_drain(op: Callable, n: int) -> None:
    """Full-then-partial drain through a store's public acquire surface:
    ask ``op`` for the whole amount; a denial retries once for the
    bucket's reported remaining balance. The bucket lands at (or near)
    empty, never negative — the fallback debit idiom shared by
    :func:`debit_source`, :func:`import_entries`, and the cluster's
    rejoin reconciliation."""
    if n <= 0:
        return
    res = await op(n)
    if not res.granted and res.remaining >= 1:
        await op(int(res.remaining))


async def _debit_buckets(store, by_config: Mapping) -> None:
    """Charge ``{(cap, rate): ([keys], [amounts])}`` bucket debits
    through the store's fastest lane: the saturating ``debit_many``
    kernel when the store has one, else a best-effort
    :func:`saturating_drain` through the public acquire surface — the
    one debit path shared by :func:`debit_source` (the old owner's
    pull-time charge) and :func:`import_entries` (the new owner's
    replay)."""
    for (cap, rate), (ks, amounts) in by_config.items():
        debit = getattr(store, "debit_many", None)
        if callable(debit):
            await debit(ks, amounts, cap, rate)
        else:  # best effort through the public surface
            for k, amt in zip(ks, amounts):
                await saturating_drain(
                    lambda m, k=k: store.acquire(k, m, cap, rate),
                    int(amt))


def debit_export(entries: dict, fraction: float) -> dict:
    """The dual-ownership budget split (module docstring): reduce every
    exported bucket's tokens by the fair-share envelope the old owner
    keeps serving from, and pre-charge every window's current count by
    its envelope — old + new together stay within the original balance
    plus one envelope."""
    out = dict(entries)
    out["buckets"] = [
        [k, cap, rate,
         max(0.0, tok - headroom_budget(cap, fraction=fraction,
                                        min_budget=1.0)), age]
        for k, cap, rate, tok, age in entries.get("buckets", ())]
    out["windows"] = [
        [k, limit, wt, interp, prev,
         min(float(limit),
             curr + headroom_budget(limit, fraction=fraction,
                                    min_budget=1.0)), behind]
        for k, limit, wt, interp, prev, curr, behind
        in entries.get("windows", ())]
    return out


async def debit_source(store, entries: Mapping, fraction: float,
                       keep_envelope: bool = True) -> None:
    """The other half of the dual-ownership partition: charge the OLD
    owner's own state for what the export shipped, at pull time.

    Without this, a handoff window that expires AFTER the destinations
    already adopted the target epoch (a slow commit under chaos delays)
    would auto-abort the source back to its full, undebited balance
    while the new owner serves the shipped remainder — the unbounded
    two-owner spend "When Two is Worse Than One" forbids. With it the
    bound holds in every termination order; a coordinator-driven abort
    merely under-admits by the shipped amount until refill (the
    conservative direction — see docs/DESIGN.md §12).

    ``keep_envelope=True`` (the wire lane) leaves each bucket the
    fair-share envelope :func:`debit_export` withheld from the shipped
    copy — the source's store residual matches the in-memory envelope
    it serves parked keys from. ``keep_envelope=False`` (the in-process
    lane, which ships balances exactly and has no parked envelope)
    drains the bucket entirely. Windows are charged to their limit in
    both lanes: the source has no authoritative window authority to
    keep — parked window keys serve from the envelope, and after an
    abort the charge expires with the window itself.

    Saturating by construction (``debit_many`` floors at zero; a raced
    admission between the snapshot and the debit is already reflected
    in the balance being debited), so any interleaving stays inside the
    bound."""
    by_config: dict[tuple, tuple[list, list]] = {}
    for key, cap, rate, tokens, _age in entries.get("buckets", ()):
        shipped = float(tokens)
        if keep_envelope:
            shipped -= headroom_budget(float(cap), fraction=fraction,
                                       min_budget=1.0)
        if shipped <= 0.0:
            continue
        ks, amounts = by_config.setdefault((float(cap), float(rate)),
                                           ([], []))
        ks.append(key)
        amounts.append(shipped)
    await _debit_buckets(store, by_config)
    charges = []
    for key, limit, wt, interp, _prev, curr, _behind in \
            entries.get("windows", ()):
        charge = int(math.floor(float(limit) - float(curr)))
        if charge > 0:
            charges.append(_window_replay(store, key, charge, limit, wt,
                                          interp))
    await asyncio.gather(*charges)


def _window_replay(store, key: str, count: int, limit: float, wt: int,
                   interp: int):
    """One window entry's acquire of ``count`` (a sliding window when
    ``interp``, else a fixed one), as an awaitable."""
    window_sec = wt / bucket_math.TICKS_PER_SECOND
    if interp:
        return store.window_acquire(key, count, limit, window_sec)
    return store.fixed_window_acquire(key, count, limit, window_sec)


def envelope_step(entry: "tuple[float, float] | None", now: float,
                  count: int, cap: float, rate: float,
                  fraction: float, priority: int = 0
                  ) -> "tuple[bool, float]":
    """One fair-share-envelope admission step — THE shared formula the
    epsilon over-admission bound depends on: a ``headroom_budget(cap,
    fraction)`` bucket refilled at ``fraction × rate``, clamped to the
    budget. ``entry`` is the stored ``(tokens, last_ts)`` or None for a
    fresh key (born at full budget). Returns ``(granted, new_tokens)``;
    callers persist ``(new_tokens, now)`` and own their eviction and
    ledger policy. Shared by the handoff :class:`_FairShareEnvelope`
    (old-owner side) and the cluster's ``_DegradedKeyspace`` (client
    edge) so the two halves of the bound can never drift apart.

    ``priority`` routes the grant rule through the ONE shed gate
    (:func:`~.runtime.admission.shed_allows`): scavenger is shed
    outright from any envelope, batch cannot spend the reserved half,
    interactive (the default — every plain wire frame) keeps the
    classic ``tokens >= count`` rule bit-for-bit."""
    from distributedratelimiting.redis_tpu_torch.runtime.admission import (
        shed_allows,
    )

    budget = headroom_budget(cap, fraction=fraction, min_budget=1.0)
    if entry is None:
        tokens = budget
    else:
        tokens, ts = entry
        tokens = min(budget, tokens + (now - ts) * rate * fraction)
    granted = shed_allows(priority, tokens, count, budget)
    if granted and count > 0:
        tokens -= count
    return bool(granted), float(tokens)


class _FairShareEnvelope:
    """Bounded local admission for parked keys during a handoff window —
    the same confidence policy as the cluster's degraded fallback
    (``headroom_budget(a, fraction)`` tokens refilled at ``fraction ×
    rate``), hosted server-side by the OLD owner. Its budget is exactly
    what :func:`debit_export` already subtracted from the shipped state,
    so envelope grants spend a balance the new owner never received."""

    _MAX_KEYS = 1 << 14

    def __init__(self, fraction: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._fraction = fraction
        self._clock = clock
        self._buckets: dict[tuple, tuple[float, float]] = {}
        self.decisions = 0

    def acquire(self, key: str, count: int, a: float, b: float,
                kind: str, priority: int = 0) -> tuple[bool, float]:
        cap, rate = ((a, b) if kind == "bucket"
                     else (a, a / b if b > 0 else 0.0))
        now = self._clock()
        k = (key, kind, float(a), float(b))
        entry = self._buckets.get(k)
        if entry is None and len(self._buckets) >= self._MAX_KEYS:
            self._buckets.pop(next(iter(self._buckets)))
        granted, tokens = envelope_step(entry, now, count, cap, rate,
                                        self._fraction, priority)
        self._buckets[k] = (tokens, now)
        self.decisions += 1
        return granted, max(tokens, 0.0)


class _Handoff:
    """One in-flight outbound migration on the old owner: the parked
    slot/key set, the cached (already-debited) export, and the envelope
    that serves the parked keys until commit, abort, or expiry."""

    __slots__ = ("target_epoch", "slots", "keys", "export", "chunks",
                 "window_s", "started_s", "envelope", "ledger",
                 "res_stash")

    def __init__(self, target_epoch: int, slots: frozenset,
                 keys: "frozenset | None", export: dict, window_s: float,
                 started_s: "float | None", fraction: float,
                 clock: Callable[[], float]) -> None:
        self.target_epoch = target_epoch
        self.slots = slots
        self.keys = keys
        self.export = export
        # Paged once here (the export is immutable from now on): every
        # page request serves a slice, never a re-chunk of the whole.
        self.chunks = chunk_entries(export)
        self.window_s = window_s
        # None while the pull still exports: the window opens once the
        # export is cached (``NodePlacementState.pull``).
        self.started_s = started_s
        self.envelope = _FairShareEnvelope(fraction, clock)
        # Reservation-ledger stash: the rows pull removed from the
        # source ledger, kept so an abort can restore them (the new
        # owner's copy only exists once a push delivered the chunk).
        self.ledger = None
        self.res_stash: "tuple[list, list] | None" = None

    def expired(self, now: float) -> bool:
        return (self.started_s is not None
                and now - self.started_s > self.window_s)


class NodePlacementState:
    """A serving node's placement half: the adopted map + this node's
    id, parked outbound handoffs, and the exactly-once import ledger.
    Engaged only once a map has been announced — a node that never hears
    an announce serves exactly as before (placement-unaware)."""

    #: Import ledger depth: applied-batch sets kept for this many most
    #: recent epochs (re-deliveries are same-epoch by construction).
    _LEDGER_EPOCHS = 8

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 envelope_fraction: float = DEFAULT_ENVELOPE_FRACTION
                 ) -> None:
        self._clock = clock
        self._fraction = envelope_fraction
        self.pmap: PlacementMap | None = None
        self.node_id: int | None = None
        self._handoffs: dict[int, _Handoff] = {}      # target epoch →
        self._parked_slots: dict[int, _Handoff] = {}  # slot →
        self._parked_keys: dict[str, _Handoff] = {}   # override key →
        self._applied: dict[int, set[int]] = {}       # epoch → batch ids
        # Target epochs whose handoff this node aborted LOCALLY (window
        # expiry — coordinator presumed dead). A post-send wire retry of
        # the original pull landing after the abort must NOT re-export:
        # the first pull already debited the source, and a second
        # export+debit double-charges it past the one-envelope bound.
        # A coordinator abort announce clears the tombstone — the
        # deliberate retry-same-epoch path stays open (and is the one
        # place a second envelope is knowingly charged).
        self._aborted_epochs: set[int] = set()
        # Reservation rows imported by this node's pushes, by target
        # epoch: (ledger, rids). The dual of the _applied reset in
        # _abort — an aborted epoch's imported rows must LEAVE this
        # ledger, or the rid lives in two gated-owner ledgers once the
        # source restores its stash and a later retry commits: a
        # settle retry then refunds on both sides (drl-verify's
        # settle-dedup counterexample). Pruned with _applied.
        self._imported_res: "dict[int, tuple] | dict" = {}
        # Serializes pull/push bodies: their idempotency checks span an
        # await (export off-thread, import through the store), and a
        # post-send retry racing the original in-flight op must wait and
        # hit the cache/ledger, not run a second export + source debit.
        self._control_lock = asyncio.Lock()
        # Visible counters (OP_STATS "placement" section + OpenMetrics).
        self.moved_errors = 0
        self.envelope_decisions = 0
        self.handoff_deferrals = 0
        self.announces = 0
        self.stale_announces = 0
        self.pulls = 0
        self.pushes_applied = 0
        self.pushes_duplicate = 0
        self.rows_imported = 0
        self.aborts = 0
        self.expired_aborts = 0
        self.res_stash_forfeited = 0

    @property
    def active(self) -> bool:
        return self.pmap is not None and self.node_id is not None

    @property
    def epoch(self) -> int:
        return -1 if self.pmap is None else self.pmap.epoch

    # -- control plane -------------------------------------------------------
    def snapshot_payload(self) -> dict:
        """The OP_PLACEMENT reply: the adopted map (or ``epoch: -1`` for
        a placement-unaware node) plus this node's id and live handoff
        state."""
        out: dict = {"epoch": self.epoch, "node_id": self.node_id,
                     "parked_slots": sorted(self._parked_slots),
                     "parked_keys": sorted(self._parked_keys)}
        if self.pmap is not None:
            out["map"] = self.pmap.to_dict()
        return out

    def announce(self, payload: Mapping) -> int:
        """Adopt an announced map (monotonic by epoch; idempotent at the
        current epoch; a STALE epoch raises). ``abort_epoch`` payloads
        instead cancel that target epoch's parked handoff — the
        coordinator's clean-abort path. Returns the adopted epoch."""
        self.announces += 1
        abort = payload.get("abort_epoch")
        if abort is not None:
            self._abort(int(abort))
            # The COORDINATOR aborted: it knows the migration failed
            # and may retry the same target epoch — re-arm pull for it
            # (unlike a local expiry abort, where a late wire retry of
            # the original pull must keep hitting the tombstone).
            self._aborted_epochs.discard(int(abort))
            return self.epoch
        pmap = PlacementMap.from_dict(payload["map"])
        node_id = payload.get("node_id")
        if self.pmap is not None:
            if pmap.epoch < self.pmap.epoch:
                self.stale_announces += 1
                raise StalePlacementError(
                    f"stale placement epoch {pmap.epoch} "
                    f"(this node adopted {self.pmap.epoch})")
            if pmap.epoch == self.pmap.epoch and pmap != self.pmap:
                # Two coordinators raced to the same target epoch with
                # different maps: adopting the second would split-brain
                # slot ownership across the fleet with no error
                # anywhere. Re-announcing the SAME map is idempotent;
                # a conflicting twin loses loudly and must rebase onto
                # the adopted epoch.
                self.stale_announces += 1
                raise StalePlacementError(
                    f"conflicting placement map at epoch {pmap.epoch}: "
                    "another coordinator already committed this epoch "
                    "with a different assignment — rebase and retry")
        self.pmap = pmap
        if node_id is not None:
            self.node_id = int(node_id)
        # Commit: any handoff whose target epoch is now current (or
        # behind it) has transferred ownership — drop the parked state;
        # the map itself answers "moved" from here on.
        for e in [e for e in self._handoffs
                  if e <= pmap.epoch]:
            self._unpark(self._handoffs.pop(e))
        # Committed epochs' imported rows are legitimately owned now —
        # drop the abort provenance so a later abort of a NEWER epoch
        # cannot evict them.
        for e in [e for e in self._imported_res if e <= pmap.epoch]:
            del self._imported_res[e]
        # Tombstones at or below the adopted epoch are unreachable
        # (pull refuses non-future epochs outright) — drop them.
        self._aborted_epochs = {e for e in self._aborted_epochs
                                if e > pmap.epoch}
        self._prune_ledger()
        return pmap.epoch

    def _abort(self, target_epoch: int, *,
               restore_reservations: bool = True) -> None:
        # A retried migration REUSES the aborted target epoch (the
        # adopted epoch never moved), so the push ledger for it must
        # reset with the abort: deduping attempt 2's batches against
        # attempt 1's would silently drop re-pushed state (init-on-miss
        # at full capacity — over-admission); re-applying is merely
        # conservative (the import's debit replay floors at zero).
        self._applied.pop(target_epoch, None)
        # The destination half: reservation rows imported under the
        # aborted epoch leave this ledger again. The source's stash
        # restore (coordinator abort) or the retry's re-export is the
        # single surviving home for each rid — without this, a settle
        # retried across the abort+retry window refunds at BOTH the
        # restored source and the stale destination copy.
        imported = self._imported_res.pop(target_epoch, None)
        if imported is not None:
            led, rids = imported
            dropper = getattr(led, "drop_rids", None)
            if callable(dropper):
                dropper(rids)
        h = self._handoffs.pop(target_epoch, None)
        if h is not None:
            self._unpark(h)
            if h.ledger is not None and h.res_stash is not None:
                if restore_reservations:
                    # A COORDINATOR abort: it only runs pre-commit, so
                    # no destination ever adopted the target epoch and
                    # the exported reservations safely come home
                    # (restore_rows skips any rid the ledger re-learned
                    # meanwhile, so a racing late push cannot
                    # double-count).
                    h.ledger.restore_rows(*h.res_stash)
                else:
                    # An EXPIRY abort: the coordinator is presumed dead
                    # and the commit MAY already have reached the
                    # destinations (dst-first commit order). Restoring
                    # the RESERVATION rows here would put the SAME rid
                    # live in two gated-owner ledgers — a retried
                    # settle then refunds on BOTH sides (drl-verify's
                    # settle-dedup counterexample). Forfeit those:
                    # settles answer the counted "unknown" no-op (the
                    # hold is never refunded — the conservative
                    # direction), and the destination copy either
                    # serves settles after its commit or TTL-expires
                    # at the estimate. DEBT rows are the opposite
                    # polarity and DO come home: dropping them would
                    # FORGIVE the tenant's overdraft (over-admission),
                    # while dual-homing debt at worst double-collects
                    # (over-denial, bounded by the per-(tag, tenant)
                    # dedup when the retry re-exports it).
                    self.res_stash_forfeited += len(h.res_stash[0])
                    if h.res_stash[1]:
                        h.ledger.restore_rows([], h.res_stash[1])
                h.res_stash = None
            self.aborts += 1
            # The export for this epoch (and its source debit) is gone:
            # refuse late re-pulls until the coordinator acknowledges
            # the abort (announce with abort_epoch clears this).
            self._aborted_epochs.add(target_epoch)

    def _unpark(self, h: _Handoff) -> None:
        for s in h.slots:
            if self._parked_slots.get(s) is h:
                del self._parked_slots[s]
        for k in h.keys or ():
            if self._parked_keys.get(k) is h:
                del self._parked_keys[k]

    async def pull(self, req: Mapping, store) -> dict:
        """MIGRATE_PULL on the old owner: park the requested slots (or
        keys), export their state with the envelope debit applied, and
        start the handoff window. Idempotent per target epoch — a
        re-delivered pull returns the cached export (the at-most-once
        client may safely retry it).

        Large exports page: the reply carries one :func:`chunk_entries`
        chunk (so it always fits MAX_FRAME) plus the total ``pages``
        count; the client fetches pages 1..N-1 with ``page`` in the
        request, served from the cached handoff export."""
        if not self.active:
            raise PlacementError(
                "no placement announced: pull requires an adopted map")
        target_epoch = int(req["target_epoch"])
        if target_epoch <= self.pmap.epoch:
            raise StalePlacementError(
                f"stale migration target epoch {target_epoch} "
                f"(this node adopted {self.pmap.epoch})")
        page = int(req.get("page", 0))
        async with self._control_lock:
            cached = self._handoffs.get(target_epoch)
            if cached is not None:
                return self._pull_page(cached, page, cached=True)
            if target_epoch in self._aborted_epochs:
                # This node already exported (and debited) for this
                # epoch and then aborted it on window expiry; the
                # cached export is gone. A silent re-export here would
                # double-debit the source — this is a late wire retry
                # of the original pull, not a coordinated new attempt.
                # The coordinator's clean-abort announce re-arms it.
                raise PlacementError(
                    f"migration to epoch {target_epoch} was aborted on "
                    "this node (handoff window expired); announce the "
                    "abort and retry the migration")
            slots = frozenset(int(s) for s in req.get("slots", ()))
            keys = (frozenset(req["keys"]) if req.get("keys") else None)
            window_s = float(req.get("window_s", 2.0))
            keep = keep_predicate(self.pmap.n_slots, self.pmap.overrides,
                                  slots, keys)
            # Parked BEFORE the export (JAX parks after it): the export
            # runs off the event loop for seconds on a large store, and a
            # moved key served from the store in that gap would ship its
            # full balance as well — old + new beyond the balance plus one
            # envelope. Parked, it serves from the envelope from here on.
            h = _Handoff(target_epoch, slots, keys, {}, window_s, None,
                         self._fraction, self._clock)
            self._handoffs[target_epoch] = h
            for s in slots:
                self._parked_slots[s] = h
            for k in keys or ():
                self._parked_keys[k] = h
            try:
                # snapshot() pulls device state to host — blocking;
                # off-loop so one pull never stalls the serving path's
                # event loop.
                entries = await asyncio.to_thread(_export_from_store,
                                                  store, keep)
            except BaseException:
                if self._handoffs.get(target_epoch) is h:
                    del self._handoffs[target_epoch]
                    self._unpark(h)
                raise
            if self._handoffs.get(target_epoch) is not h:
                # An abort announce landed during the export: nothing was
                # debited or moved, so the source keeps serving its store.
                raise PlacementError(
                    f"migration to epoch {target_epoch} was aborted "
                    "during its export")
            # Outstanding reservations (and debts) whose TENANT moves
            # ride the same export: their settles will land on the new
            # owner (the tenant's MOVED target), so the ledger entries
            # must be there to reconcile against. Removed from the
            # source ledger here; an abort restores them (stash below).
            led = getattr(store, "_reservations", None)
            res_stash = None
            if led is not None:
                # Tag = the export episode: a same-epoch retry after an
                # abort re-ships the restored debts under the SAME tag,
                # and an owner already holding attempt 1's copy skips
                # them (ReservationLedger.restore_rows).
                res_rows, debt_rows = led.export_rows(
                    keep, tag=f"epoch:{target_epoch}")
                if res_rows or debt_rows:
                    entries = dict(entries)
                    entries["reservations"] = res_rows
                    entries["debts"] = debt_rows
                    res_stash = (res_rows, debt_rows)
            h.export = debit_export(entries, self._fraction)
            h.chunks = chunk_entries(h.export)
            h.started_s = self._clock()
            h.ledger = led
            h.res_stash = res_stash
            # Charge this store for the shipped amount NOW (parked keys
            # serve from the envelope meanwhile): the authoritative
            # residual equals the envelope, so even a handoff that
            # expires after a slow commit announced the new epoch cannot
            # resume a full undebited balance alongside the new owner
            # (see debit_source).
            await debit_source(store, entries, self._fraction,
                               keep_envelope=True)
            self.pulls += 1
            return self._pull_page(h, page, cached=False)

    def _pull_page(self, h: _Handoff, page: int, cached: bool) -> dict:
        if not 0 <= page < len(h.chunks):
            raise PlacementError(
                f"pull page {page} out of range (export has "
                f"{len(h.chunks)} pages)")
        return {"target_epoch": h.target_epoch, "node_id": self.node_id,
                "entries": h.chunks[page], "pages": len(h.chunks),
                "cached": cached}

    async def push(self, req: Mapping, store) -> int:
        """MIGRATE_PUSH on the new owner: import one handoff batch
        exactly once — a re-delivered ``(target_epoch, batch)`` is a
        counted no-op, never a double-apply (the lock covers the
        in-flight duplicate too: the dedup check and the import span an
        await)."""
        target_epoch = int(req["target_epoch"])
        batch = int(req.get("batch", 0))
        async with self._control_lock:
            applied = self._applied.setdefault(target_epoch, set())
            if batch in applied:
                self.pushes_duplicate += 1
                return 0
            entries = req.get("entries") or {}
            n = await import_entries(store, entries)
            applied.add(batch)
            # Provenance for the abort path: remember which reservation
            # rids this epoch's pushes put into our ledger, so an abort
            # can take them back out (see _abort / _imported_res).
            rids = [row[1] for row in (entries.get("reservations")
                                       or ())]
            if rids:
                maker = getattr(store, "reservation_ledger", None)
                if callable(maker):
                    led, seen = self._imported_res.setdefault(
                        target_epoch, (maker(), set()))
                    seen.update(str(r) for r in rids)
            self.pushes_applied += 1
            self.rows_imported += n
            self._prune_ledger()
            return n

    def _prune_ledger(self) -> None:
        while len(self._applied) > self._LEDGER_EPOCHS:
            del self._applied[min(self._applied)]
        while len(self._imported_res) > self._LEDGER_EPOCHS:
            # Evicting abort provenance must not strand the rows it
            # tracks: a later abort of the evicted epoch would find no
            # record and leave them dual-homed (the double-refund this
            # machinery closes). Drop them NOW instead — the
            # conservative direction: if that epoch somehow still
            # commits, its settles answer the counted "unknown" (no
            # refund), never a second one.
            led, rids = self._imported_res.pop(
                min(self._imported_res))
            dropper = getattr(led, "drop_rids", None)
            if callable(dropper):
                dropper(rids)

    # -- serving gate --------------------------------------------------------
    def gate(self, key: str):
        """The serving-path ownership check. Returns ``None`` (serve
        authoritatively), ``("envelope", handoff)`` (parked mid-handoff:
        admission ops serve the fair-share envelope), or ``("moved",
        owner)`` (answer the routable moved error). Expired handoffs
        auto-abort here — coordinator loss must not strand a keyspace."""
        if not self.active:
            return None
        h = self._parked_keys.get(key)
        if h is None and key not in self.pmap.overrides:
            # Override keys route (and migrate) independently of their
            # slot — a parked slot does not park its split-out keys.
            h = self._parked_slots.get(self.pmap.slot_of(key))
        if h is not None:
            if h.expired(self._clock()):
                # The commit never came: abort back to the old epoch.
                # Safe in BOTH races — if the target epoch was never
                # announced no client routes to the new owner, and if a
                # slow commit DID announce it, this store was already
                # debited down to the envelope at pull time
                # (debit_source), so resuming authoritative serving
                # stays inside the dual-ownership bound. Reservation
                # rows are NOT restored on this path (unlike a
                # coordinator abort): they were moved whole, not
                # debited, so restoring them under a slow commit would
                # double-home the rid — see _abort.
                self._abort(h.target_epoch, restore_reservations=False)
                self.expired_aborts += 1
            else:
                return ("envelope", h)
        owner = self.pmap.node_of(key)
        if owner != self.node_id:
            self.moved_errors += 1
            return ("moved", owner)
        return None

    def bulk_gate(self, keys: Sequence[str]):
        """Ownership masks for one bulk frame. Returns ``None`` when
        every row serves authoritatively (the overwhelming steady-state
        — one vectorized crc32 pass plus a table compare), else
        ``(serve_mask, envelope_rows, moved_mask)`` where
        ``envelope_rows`` is ``[(row_index, handoff), …]``. Expired
        handoffs auto-abort first, exactly like the scalar gate."""
        if not self.active:
            return None
        now = self._clock()
        for e in [e for e, h in self._handoffs.items()
                  if h.expired(now)]:
            self._abort(e, restore_reservations=False)
            self.expired_aborts += 1
        pmap = self.pmap
        slots = route_keys(keys, pmap.n_slots)
        owners = pmap.slot_owner[slots]
        parked = (np.isin(slots, np.fromiter(self._parked_slots,
                                             np.int64,
                                             len(self._parked_slots)))
                  if self._parked_slots else
                  np.zeros(len(slots), bool))
        if pmap.overrides or self._parked_keys:
            # Slot prefilter (route()'s discipline): only rows hashing
            # into an override or parked key's slot pay the per-key
            # probe — a long-lived hot-split table must not put every
            # bulk frame's every row back on a Python string loop.
            ov, pk = pmap.overrides, self._parked_keys
            special = pmap.override_slots()
            if pk:
                special = np.union1d(special, np.fromiter(
                    (_slot_of(k, pmap.n_slots) for k in pk),
                    np.int64, len(pk)))
            cand = np.isin(slots, special)
            for i in np.nonzero(cand)[0]:
                k = keys[int(i)]
                j = ov.get(k)
                if j is not None:
                    owners[i] = j
                    parked[i] = False  # overrides route independently
                if k in pk:
                    parked[i] = True
        serve_mask = (owners == self.node_id) & ~parked
        if serve_mask.all():
            return None
        moved_mask = (owners != self.node_id) & ~parked
        envelope_rows = []
        if parked.any():
            for i in np.nonzero(parked)[0]:
                k = keys[int(i)]
                h = self._parked_keys.get(k)
                if h is None:
                    h = self._parked_slots.get(int(slots[i]))
                if h is not None:
                    envelope_rows.append((int(i), h))
                else:  # raced an abort: the map still owns it here
                    serve_mask[i] = owners[i] == self.node_id
                    moved_mask[i] = not serve_mask[i]
        self.moved_errors += int(moved_mask.sum())
        return serve_mask, envelope_rows, moved_mask

    def moved_message(self, key: str, owner: int) -> str:
        return (f"{MOVED_ERROR_PREFIX}: key routes to node {owner} at "
                f"epoch {self.pmap.epoch}")

    def deferral_message(self, h: _Handoff, what: str = "key") -> str:
        """The transient deferral of a parked key (or tenant) whose op has
        no envelope value; counted."""
        self.handoff_deferrals += 1
        return (f"{HANDOFF_DEFERRAL_PREFIX} for this {what} (target epoch "
                f"{h.target_epoch}); retry shortly")

    def envelope_acquire(self, h: _Handoff, key: str, count: int,
                         a: float, b: float, kind: str,
                         priority: int = 0) -> tuple[bool, float]:
        self.envelope_decisions += 1
        return h.envelope.acquire(key, count, a, b, kind, priority)

    def stats(self) -> dict:
        out = {
            "epoch": self.epoch,
            "node_id": self.node_id,
            "parked_slots": len(self._parked_slots),
            "parked_keys": len(self._parked_keys),
            "moved_errors": self.moved_errors,
            "envelope_decisions": self.envelope_decisions,
            "handoff_deferrals": self.handoff_deferrals,
            "pulls": self.pulls,
            "pushes_applied": self.pushes_applied,
            "pushes_duplicate": self.pushes_duplicate,
            "rows_imported": self.rows_imported,
            "aborts": self.aborts,
            "expired_aborts": self.expired_aborts,
            "res_stash_forfeited": self.res_stash_forfeited,
        }
        if self.pmap is not None and self.node_id is not None:
            out["owned_slots"] = int(
                (self.pmap.slot_owner == self.node_id).sum())
        return out


async def serve_gated_bulk(ps: NodePlacementState, gate, keys, counts,
                           rows: np.ndarray, a: float, b: float, kind: int,
                           store_call, granted: np.ndarray,
                           remaining: "np.ndarray | None") -> None:
    """The rows ``rows`` of one bulk frame that ``ps.bulk_gate`` stopped
    with no moved row: the owned ones in one ``store_call(keys, counts)``,
    then the parked ones from their handoff envelopes in row order. The
    verdicts land in ``granted`` and ``remaining`` (``None``: not asked) at
    each row's position in ``rows``. Both wire lanes serve gated frames
    through this."""
    serve_mask, envelope_rows, _moved = gate
    counts = np.asarray(counts, np.int64)
    pos = np.nonzero(serve_mask[rows])[0]
    if len(pos):
        sel = rows[pos]
        res = await store_call([keys[int(i)] for i in sel], counts[sel])
        granted[pos] = res.granted
        if remaining is not None and res.remaining is not None:
            remaining[pos] = res.remaining
    where = np.full(len(keys), -1, np.int64)
    where[rows] = np.arange(len(rows))
    ekind = BULK_ENVELOPE_KIND[kind]
    for i, h in envelope_rows:
        p = int(where[i])
        if p >= 0:
            g, rem = ps.envelope_acquire(h, keys[i], int(counts[i]), a, b,
                                         ekind)
            granted[p] = g
            if remaining is not None:
                remaining[p] = rem


# -- store import/export lanes ----------------------------------------------

def _export_from_store(store, keep: Callable[[str], bool]) -> dict:
    """Prefer a store's own ``export_entries`` override; fall back to
    filtering its snapshot through the schema-aware extractor."""
    exporter = getattr(store, "export_entries", None)
    if callable(exporter):
        return exporter(keep)
    return extract_entries(store.snapshot(), keep)


async def import_entries(store, entries: Mapping) -> int:
    """Apply normalized entries to any store. A store-provided
    ``import_entries`` override (the exact host-dict merge) wins;
    otherwise the **generic replay lane** adopts the state through the
    store's public ops:

    - buckets via the saturating **debit kernel** (``debit_many`` — the
      round-5/tier-0 state primitive): a fresh key initializes at full
      capacity and ``capacity − tokens`` is debited away, landing the
      migrated balance exactly, batched per ``(capacity, rate)`` config;
    - windows by replaying the current window's count (prior windows'
      interpolated share is dropped — conservative only toward admission,
      inside the handoff epsilon);
    - counters via ``sync_counter`` (a fresh counter adopts the pushed
      value); semaphores via ``concurrency_acquire``.

    Returns the number of rows applied."""
    n = 0
    # Reservation-ledger sections route to the store's attached ledger
    # BEFORE the store-specific importer branch — both import lanes
    # (exact host-dict merge and generic replay) must adopt them, and
    # the ledger is shared with the serving path by construction
    # (BucketStore.reservation_ledger), so the next settle sees them.
    res_rows = entries.get("reservations") or ()
    debt_rows = entries.get("debts") or ()
    if res_rows or debt_rows:
        maker = getattr(store, "reservation_ledger", None)
        if callable(maker):
            n += maker().restore_rows(res_rows, debt_rows)
    importer = getattr(store, "import_entries", None)
    if callable(importer):
        return n + await importer(entries)
    by_config: dict[tuple, tuple[list, list]] = {}
    for key, cap, rate, tokens, _age in entries.get("buckets", ()):
        ks, amounts = by_config.setdefault((float(cap), float(rate)),
                                           ([], []))
        ks.append(key)
        amounts.append(max(0.0, float(cap) - float(tokens)))
        n += 1
    await _debit_buckets(store, by_config)
    # Each section's rows are distinct entries: replayed concurrently, the
    # store's micro-batcher decides them in flushes (module docstring).
    windows = entries.get("windows", ())
    await asyncio.gather(*(
        _window_replay(store, key, int(math.ceil(curr)), limit, wt, interp)
        for key, limit, wt, interp, _prev, curr, behind in windows
        if behind == 0 and curr > 0))
    counters = entries.get("counters", ())
    await asyncio.gather(*(store.sync_counter(key, float(value), 0.0)
                           for key, value, _period, _age in counters))
    semas = entries.get("semas", ())
    await asyncio.gather(*(store.concurrency_acquire(key, int(active),
                                                     int(active))
                           for key, active in semas))
    return n + len(windows) + len(counters) + len(semas)
