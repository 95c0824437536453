"""Wire protocol for the remote store — the framework's RESP/EVALSHA analogue.

This is the PyTorch package's copy of the JAX package's ``runtime/wire.py``:
the same constants, frame layouts and codec, byte for byte, so that a
client of either package talks to a server of either package
(``tests/test_torch_wire.py`` holds the two codecs to identical bytes).
The notes below describe the protocol as both packages speak it; ops that
the PyTorch server does not serve yet answer a routable error (see
``runtime/server.py``).

The reference's entire comm stack is a multiplexed TCP connection carrying
``EVALSHA`` invocations of prepared scripts (SURVEY.md §5.8,
``StackExchange.Redis`` + ``ScriptEvaluateAsync``). Here the same star
topology is served by a compact length-prefixed binary protocol: clients
pipeline requests tagged with a sequence id over one connection; the server
executes each against its local :class:`BucketStore` (typically the
TPU-resident :class:`DeviceBucketStore`, whose micro-batcher coalesces
concurrent requests from all connections into single kernel launches) and
replies out of completion order.

Frame layout (all integers little-endian):

    [u32 length][u8 version][u32 seq][u8 op][payload…]

``version`` is :data:`PROTOCOL_VERSION`; a mismatch raises before any
payload is interpreted, so any *future* revision (v2+, all carrying the
byte) is reliably detectable rather than silently misparsed. (A legacy
v1 peer — whose layout had no version byte — is detected probabilistically:
its seq's low byte sits where the version now is, so 1-in-256 v1 frames
can slip past the gate; v1 predates any release, so this is theoretical.)
The reference inherits version/auth negotiation from the Redis
``Configuration`` string (``RedisTokenBucketRateLimiterOptions.cs:30-40``);
see ``OP_HELLO`` for the auth analogue.

Request payloads:
    ACQUIRE / WINDOW : [u16 klen][key utf-8][i32 count][f64 a][f64 b]
                       (a, b) = (capacity, fill_rate) / (limit, window_s)
    PEEK             : [u16 klen][key utf-8][f64 capacity][f64 fill_rate]
    SYNC             : [u16 klen][key utf-8][f64 local_count][f64 decay_rate]
    HELLO            : [u16 tlen][token utf-8] (shared-secret auth; must be
                       the first frame when the server requires a token)
    PING / SAVE / STATS : empty (SAVE writes the server-configured
                       checkpoint path — clients never supply paths)
    ACQUIRE_MANY     : [u8 flags][f64 a][f64 b][u32 n]
                       [u16 klen × n][key blob utf-8][u32 count × n]
                       — one frame decides n keys' requests (the bulk path;
                       flags bit 0 = caller wants per-request remaining;
                       flags bits 1-2 = table kind: 0 token bucket with
                       (a, b) = (capacity, fill_rate), 1 sliding window /
                       2 fixed window with (a, b) = (limit, window_s)).
                       Length/count arrays are raw little-endian vectors so
                       both ends move them with numpy, not per-key packing.
                       Keys are byte strings end-to-end on the serving
                       path (the server resolves them from the frame blob
                       natively — ``KeyBlob``); invalid UTF-8 rate-limits
                       under its own stable identity rather than erroring
                       the frame, matching the native front-end's
                       per-request lane.
                       Clients split larger bulks into multiple frames via
                       :func:`bulk_chunk_spans` (every chunk ≤ MAX_FRAME)
                       and pipeline the chunks on one connection.

Response payloads:
    OK_DECISION : [u8 granted][f64 remaining]
    OK_VALUE    : [f64 value]
    OK_PAIR     : [f64 a][f64 b]
    OK_EMPTY    : empty
    OK_TEXT     : [u32 mlen][text utf-8] (STATS reply: a JSON object —
                  u32 so a large stats payload can never be truncated
                  mid-UTF-8; bounded by MAX_FRAME)
    OK_BULK     : [u8 flags][u32 n][granted bits, (n+7)//8 bytes, LSB-first]
                  [f32 remaining × n, present iff flags bit 0] — 1 bit per
                  verdict (+4B optional estimate), so a full MAX_FRAME
                  request's reply stays well under MAX_FRAME
    ERROR       : [u16 mlen][message utf-8] (truncated on a codepoint
                  boundary if oversized)

Version history: v1 had no version byte and a u16 OK_TEXT length; v2
added the version byte, HELLO, the u32 OK_TEXT length, and
ACQUIRE_MANY/OK_BULK; v3 gave ACQUIRE_MANY's flags byte the table-kind
bits; v4 (current) added the chained-chunk bit (chunk ordering became
opt-in per frame — a v3 client relying on the old serialize-all-bulk
behavior must not slip through). OP_METRICS (OpenMetrics exposition)
and the OP_STATS flag BITS (reset / flight-dump) arrived within v4: a
new op and a widened already-optional flag byte change no existing
frame's meaning, so an old server answers with a routable error rather
than a misread. The placement/migration control plane (OP_PLACEMENT /
OP_PLACEMENT_ANNOUNCE / OP_MIGRATE_PULL / OP_MIGRATE_PUSH, round 6)
arrived the same way — and every one of them is additionally
*application-idempotent* (epoch-monotonic announce, per-epoch cached
pull, batch-deduped push), so the client may retry them even post-send
without violating the at-most-once admission contract. Semantic changes to an existing frame always bump the
version: a silent misread loses decisions, the strict version check
fails loudly instead.

Trace context (within v4, same compatibility posture as OP_METRICS):
a sampled request may carry a 25-byte trace tail —
``[u64 trace_hi][u64 trace_lo][u64 parent span][u8 flags]`` — appended
after the payload. Scalar keyed frames signal it with :data:`TRACE_FLAG`
(bit 7) on the op byte; ACQUIRE_MANY signals it with flags bit 4. An
old peer stays safe on BOTH lanes: a flagged scalar op decodes as
"unknown op 129" — a routable error, never a misparse (clients latch
off stamping and retry bare on seeing it) — while an old bulk decoder
reads its arrays by explicit counts and simply never looks at the tail,
so traced bulk frames interoperate unchanged. OP_TRACES (Chrome-trace
JSON export) is a new op on the existing layout, routable-error on old
servers like OP_METRICS.

Deadline tail (within v4, same posture): a scalar request may carry an
8-byte relative deadline — ``[f64 deadline_s]`` — appended after the
payload (BEFORE any trace tail) and signalled with :data:`DEADLINE_FLAG`
(op-byte bit 6). The value is the client's remaining budget in seconds,
deliberately *relative*: client and server clocks never compare
(invariant 1). A server strips it and sheds the request — routable
"deadline exceeded" error, store untouched — when its own queueing has
already consumed the budget, instead of answering the dead. An old
server answers the flagged op with a routable "unknown op" error and
the client latches deadline stamping off for the connection (the trace
latch's posture); the native C front-end routes flagged scalar ops to
the Python passthrough lane, which speaks this dialect.

Attempt tail (within v4, same posture — the retry-storm defense,
docs/DESIGN.md §24): a RETRY of a scalar request may carry a 1-byte
attempt counter — ``[u8 attempt]`` — appended after the payload
(BEFORE the deadline tail, which rides before the trace tail) and
signalled with :data:`ATTEMPT_FLAG` (op-byte bit 5). First attempts
are never stamped, so the healthy path stays byte-identical to plain
v4; the counter saturates at 255. A server under retry-shed denies
flagged work with a routable error before the store is touched; an
old server answers the flagged op with a routable "unknown op" error
and the client latches attempt stamping off for the connection —
independently of the deadline latch, each tail degrades alone. The
bulk lane signals the SAME defense with ``BULK_FLAG_DEADLINE`` (flags
bit 5): a 9-byte ``[f64 deadline_s][u8 attempt]`` tail after the
tenant extension, before any trace tail — old bulk decoders read
their arrays by explicit counts and never look at it, so no latch is
needed on that lane.

Tenant extension (within v4, OP_METRICS posture — the token-denominated
admission plane, runtime/admission.py, DESIGN.md §15):

- ``OP_ACQUIRE_H`` is hierarchical (tenant → key) weighted-cost
  admission: the OP_ACQUIRE payload followed by a tenant extension —
  ``[u16 tlen][tenant utf-8][f64 tenant_a][f64 tenant_b][u8 priority]``
  (``_HIER_TAIL`` after the tenant id) — decided grant-iff-both-levels
  against the child ``(a, b)`` bucket AND the parent tenant
  ``(tenant_a, tenant_b)`` bucket in one fused kernel launch. A new op
  on the existing frame layout: an old server answers a routable
  "unknown op" error (never a misparse) and the client latches tenant
  stamping off for the connection, falling back to child-only flat
  admission (counted — availability over tenant-budget accuracy, the
  degraded-mode posture of invariant 9). The native C front-end routes
  op 19 to the Python passthrough lane (its scalar switch names only
  the ops it fast-paths — drl-check's ``wire-hier`` rule pins this).
- ``BULK_KIND_HBUCKET`` (table-kind bits value 3) is the bulk edition:
  one ACQUIRE_MANY frame carries ONE tenant's rows, with the same
  tenant extension appended after the counts array (before any trace
  tail). Old bulk decoders answer a routable "unknown bulk kind 3"
  error; the C bulk fast lane's kind gate routes it to Python.
- ``priority`` is the request's priority class
  (:mod:`~.runtime.admission`: 0 interactive / 1 batch / 2 scavenger).
  It never changes a healthy-path decision; envelope serving (drain
  windows, parked handoffs, degraded fallback) honors the shed order —
  scavenger sheds first, the envelope is spent on interactive.

Reservation lane (within v4, OP_METRICS posture — streaming token
costs, :mod:`~.runtime.reservations`, DESIGN.md §18): ``OP_RESERVE`` /
``OP_SETTLE`` carry u32-length-prefixed JSON like the other control
ops (``TEXT_OPS``) and reply RESP_TEXT JSON. Both are *application-
idempotent by reservation id* — a retried reserve of a granted id
replays the recorded decision without a second debit, a retried settle
replays the recorded reconciliation — so both sit in the client's
post-send-retryable set. An old server answers either with a routable
unknown-op error; the client latches once per connection and falls
back to plain ``acquire_hierarchical`` at the estimate (counted —
refunds are forgone against that peer, the conservative direction).

Federation lane (within v4, OP_METRICS posture — the WAN lease ledger,
:mod:`~.runtime.federation`, DESIGN.md §20): ``OP_FED_LEASE`` /
``OP_FED_RENEW`` / ``OP_FED_RECLAIM`` carry u32-length-prefixed JSON
(``TEXT_OPS``) and reply RESP_TEXT JSON. All three are *application-
idempotent* — lease and reclaim replay their per-lease-id recorded
results (the OP_RESERVE dedup posture), renew is absorbing by
construction (monotonic admitted totals + epoch-monotonic slice
adoption, the OP_CONFIG discipline) — so every one of them sits in the
client's post-send-retryable set: a WAN retry mid-partition can never
double-grant a slice or double-refund a reclaim. An old home answers
any of them with a routable unknown-op error; the regional client
latches once per connection (counted) and keeps serving from its
current slice until lease expiry, then degrades to its fair-share
envelope — federation unavailability is indistinguishable from a
partition, by design never unlimited and never hard-down.
"""

from __future__ import annotations

import struct

import numpy as np

from distributedratelimiting.redis_tpu_torch.utils.tracing import TraceContext

__all__ = [
    "OP_ACQUIRE", "OP_PEEK", "OP_SYNC", "OP_WINDOW", "OP_PING",
    "OP_SAVE", "OP_STATS", "OP_SEMA", "OP_FWINDOW", "OP_HELLO",
    "OP_ACQUIRE_MANY", "OP_METRICS", "OP_TRACES",
    "OP_PLACEMENT", "OP_PLACEMENT_ANNOUNCE", "OP_MIGRATE_PULL",
    "OP_MIGRATE_PUSH", "OP_CONFIG", "OP_ACQUIRE_H", "OP_RESERVE",
    "OP_SETTLE", "OP_FED_LEASE", "OP_FED_RENEW", "OP_FED_RECLAIM",
    "OP_AUDIT",
    "TEXT_OPS",
    "TRACE_FLAG", "TRACE_TAIL_LEN", "BULK_FLAG_TRACED",
    "DEADLINE_FLAG", "DEADLINE_TAIL_LEN",
    "ATTEMPT_FLAG", "ATTEMPT_TAIL_LEN", "BULK_FLAG_DEADLINE",
    "BULK_DEADLINE_TAIL_LEN",
    "strip_trace", "bulk_trace_tail", "strip_deadline",
    "strip_attempt", "bulk_deadline_tail",
    "STATS_FLAG_RESET", "STATS_FLAG_FLIGHT_DUMP",
    "RESP_DECISION", "RESP_VALUE", "RESP_PAIR", "RESP_EMPTY", "RESP_TEXT",
    "RESP_BULK", "RESP_ERROR",
    "MAX_FRAME", "PROTOCOL_VERSION", "RemoteStoreError",
    "ProtocolVersionError", "op_name",
    "encode_request", "decode_request", "encode_response", "decode_response",
    "decode_hierarchical_request", "bulk_hier_tail",
    "encode_bulk_request", "decode_bulk_request", "encode_bulk_response",
    "bulk_chunk_spans", "KeyBlob", "decode_key_blob",
    "BULK_KIND_BUCKET", "BULK_KIND_WINDOW", "BULK_KIND_FWINDOW",
    "BULK_KIND_HBUCKET", "HIER_TAIL_LEN",
    "BULK_REQ_HEAD_LEN", "BULK_RESP_HEAD_LEN",
    "read_frame", "write_frame",
]

PROTOCOL_VERSION = 4

OP_ACQUIRE = 1
OP_PEEK = 2
OP_SYNC = 3
OP_WINDOW = 4
OP_PING = 5
OP_SAVE = 6    # ≙ Redis BGSAVE: checkpoint the store server-side
OP_STATS = 7   # server + store metrics as JSON text
OP_SEMA = 8    # concurrency semaphore: count = signed delta, a = limit
OP_FWINDOW = 9  # fixed-window acquire: (a, b) = (limit, window_s)
OP_HELLO = 10  # shared-secret auth handshake (≙ Redis AUTH)
OP_ACQUIRE_MANY = 11  # bulk acquire: n keys' decisions in one frame
OP_METRICS = 12  # OpenMetrics text exposition (RESP_TEXT reply). A new
# op on the existing frame layout needs no version bump: an older server
# answers it with a routable unknown-op error, never a misparse.
OP_TRACES = 13  # Chrome-trace-event JSON export of the server's kept
# traces (RESP_TEXT reply); optional one-byte flag: bit 0 drains the
# buffer after export. Same compatibility posture as OP_METRICS.

# -- placement / migration control plane (within v4, OP_METRICS posture:
# new ops on the existing frame layout — an old server answers each with
# a routable unknown-op error, never a misparse; see runtime/placement.py
# and docs/DESIGN.md §12).
OP_PLACEMENT = 14  # fetch the node's adopted placement map (empty
# request → RESP_TEXT JSON: epoch, node_id, slot_owner, overrides,
# parked handoff state; epoch -1 = placement-unaware node).
OP_PLACEMENT_ANNOUNCE = 15  # adopt a placement map (or abort a target
# epoch): [u32 mlen][json] → RESP_VALUE adopted epoch. Epoch-monotonic
# and idempotent at the current epoch; a stale epoch is a routable
# error, so announce retries are always safe.
OP_MIGRATE_PULL = 16  # old owner: export + park the listed slots/keys
# for a target epoch — [u32 mlen][json {target_epoch, slots|keys,
# window_s}] → RESP_TEXT JSON {entries, …}. Idempotent per target epoch
# (a re-delivered pull returns the cached, already-debited export).
OP_MIGRATE_PUSH = 17  # new owner: import one handoff batch —
# [u32 mlen][json {target_epoch, batch, entries}] → RESP_VALUE rows
# applied. Exactly-once per (target_epoch, batch): a re-delivered batch
# is a counted no-op, never a double-apply.
OP_CONFIG = 18  # live config mutation (runtime/liveconfig.py, round 7;
# OP_METRICS posture — a new op on the existing frame layout, routable
# unknown-op error from old servers): [u32 mlen][json] where {} fetches
# the committed rules (RESP_TEXT), {"prepare": rule, "version": v} /
# {"commit": v} / {"abort": v} drive the two-phase mutation
# (RESP_VALUE committed version). Version-monotonic and idempotent at
# every form — the OP_PLACEMENT_ANNOUNCE discipline — so post-send
# retries are always safe.

OP_ACQUIRE_H = 19  # hierarchical (tenant → key) weighted-cost acquire
# (runtime/admission.py; OP_METRICS posture — a new op on the existing
# frame layout, routable unknown-op error from old servers, never a
# misparse): the OP_ACQUIRE payload followed by the tenant extension
# [u16 tlen][tenant][_HIER_TAIL]. Decoded via
# decode_hierarchical_request; decided grant-iff-both-levels with
# parent refund on child deny (both-or-neither state change). The
# native C front-end names the op only to pin its Python-lane
# fallthrough (drl-check wire-hier).

OP_RESERVE = 20  # estimate-reserve-settle, phase 1 (runtime/
# reservations.py; OP_METRICS posture — a new op on the existing frame
# layout, routable unknown-op error from old servers, never a misparse;
# the client latches a fallback to plain acquire_hierarchical at the
# estimate): [u32 mlen][json {rid, tenant, key, estimate?, a, b, ta,
# tb, priority?, ttl_s?}] → RESP_TEXT JSON {granted, reserved,
# remaining, debt, duplicate}. Application-idempotent by reservation
# id (a granted rid's retry replays the recorded decision without a
# second debit), so post-send retries are always safe.
OP_SETTLE = 21  # estimate-reserve-settle, phase 3: [u32 mlen][json
# {rid, tenant, actual}] → RESP_TEXT JSON {outcome, delta, refunded,
# debt}. Idempotent by reservation id — a duplicate settle replays the
# recorded result (outcome "duplicate", zero side effects), which is
# what makes the op post-send-retry-safe. Routed by TENANT like
# OP_ACQUIRE_H (the ledger entry lives with the tenant's owner).

OP_FED_LEASE = 22  # global quota federation, phase 1 (runtime/
# federation.py; OP_METRICS posture — a new op on the existing frame
# layout, routable unknown-op error from old homes, never a misparse):
# [u32 mlen][json {region, lease_id, tenant, demand, total,
# global_cap, global_rate, ttl_s?}] → RESP_TEXT JSON {granted,
# lease_id, epoch, slice: [cap, rate], ttl_s, share, debt,
# duplicate} — `total` is the region's monotonic admitted counter,
# seeding the lease's report baseline. Application-
# idempotent by LEASE ID (a granted lease_id's retry replays the
# recorded grant without a second share debit — the OP_RESERVE
# posture), so WAN post-send retries are always safe.
OP_FED_RENEW = 23  # federation heartbeat + demand report:
# [u32 mlen][json {region, lease_id, tenant, total, demand}] →
# RESP_TEXT JSON {outcome, epoch, slice, ttl_s, charged, refunded,
# debt}. Naturally idempotent: `total` is the region's MONOTONIC
# admitted-token counter (a replayed renew's delta is zero) and slice
# changes carry an epoch the region adopts only forward (the OP_CONFIG
# version discipline) — post-send-retry-safe without a dedup ledger.
OP_FED_RECLAIM = 24  # return a slice to the federation pool:
# [u32 mlen][json {region, lease_id, tenant, total}] → RESP_TEXT JSON
# {outcome, charged, refunded, debt}. Idempotent by lease id — a
# duplicate reclaim replays the recorded result (outcome "duplicate",
# zero side effects: no second share free, no second refund), the
# at-most-once property tests/test_federation.py audits.

OP_AUDIT = 25  # conservation audit plane (runtime/audit.py; OP_METRICS
# posture — a new op on the existing frame layout, routable unknown-op
# error from old servers, never a misparse): [u32 mlen][json {}] or
# {"bundles": n} → RESP_TEXT JSON — the node's conservation-ledger
# snapshot (per-source ε-budget utilization, per-subsystem residues,
# watchdog state) plus, when asked, the newest n black-box incident
# bundles. Read-only (no store mutation, no window reset), so retries
# are trivially safe.

#: Control ops whose request payload is one u32-length-prefixed UTF-8
#: JSON text (rides in the ``key`` slot of encode/decode_request —
#: ensure_ascii JSON, so the strict codec never meets a surrogate).
TEXT_OPS = frozenset((OP_PLACEMENT_ANNOUNCE, OP_MIGRATE_PULL,
                      OP_MIGRATE_PUSH, OP_CONFIG, OP_RESERVE,
                      OP_SETTLE, OP_FED_LEASE, OP_FED_RENEW,
                      OP_FED_RECLAIM, OP_AUDIT))

#: Op-byte bit 7: a 25-byte trace tail (``_TRACE_TAIL``) follows the
#: payload. Only sampled requests carry it; an old server answers the
#: flagged op with a routable "unknown op" error (clients latch off).
TRACE_FLAG = 0x80
_TRACE_TAIL = struct.Struct("<QQQB")  # trace_hi, trace_lo, span_id, flags
TRACE_TAIL_LEN = _TRACE_TAIL.size
#: ACQUIRE_MANY flags bit 4: the same 25-byte tail follows the counts
#: array. Old bulk decoders read by explicit counts and ignore the tail.
BULK_FLAG_TRACED = 0b10000

#: Op-byte bit 6: an 8-byte relative-deadline tail (``_DEADLINE_TAIL``)
#: follows the payload (before any trace tail). Old servers answer the
#: flagged op with a routable "unknown op" error (clients latch off);
#: scalar ops only — the bulk lane stays deadline-free by design (a
#: bulk call is one caller's single decision batch, its timeout is its
#: own).
DEADLINE_FLAG = 0x40
_DEADLINE_TAIL = struct.Struct("<d")  # remaining budget, seconds
DEADLINE_TAIL_LEN = _DEADLINE_TAIL.size

#: Op-byte bit 5: a 1-byte attempt-counter tail (``_ATTEMPT_TAIL``)
#: follows the payload (before the deadline tail — tail order on the
#: wire is attempt, deadline, trace; servers strip trace → deadline →
#: attempt). Stamped only on RETRIES (attempt ≥ 1, saturating at 255):
#: first attempts stay byte-identical to plain v4, and an old server
#: answers the flagged op with a routable "unknown op" error — the
#: client latches attempt stamping off for the connection,
#: independently of the deadline latch.
ATTEMPT_FLAG = 0x20
_ATTEMPT_TAIL = struct.Struct("<B")  # attempt number, saturating u8
ATTEMPT_TAIL_LEN = _ATTEMPT_TAIL.size

#: ACQUIRE_MANY flags bit 5: a 9-byte ``[f64 deadline_s][u8 attempt]``
#: tail follows the payload (after any HBUCKET tenant extension, before
#: any trace tail). The bulk edition of the deadline + attempt tails in
#: one piece — old bulk decoders read their arrays by explicit counts
#: and never look at it, so the bulk lane needs no client latch (the
#: BULK_FLAG_TRACED posture).
BULK_FLAG_DEADLINE = 0b100000
_BULK_DEADLINE_TAIL = struct.Struct("<dB")  # deadline_s, attempt
BULK_DEADLINE_TAIL_LEN = _BULK_DEADLINE_TAIL.size

#: Tenant extension tail (after the ``[u16 tlen][tenant]`` id):
#: parent-bucket config operands + the request's priority class.
#: Rides OP_ACQUIRE_H (after the OP_ACQUIRE-shaped payload) and
#: BULK_KIND_HBUCKET ACQUIRE_MANY frames (after the counts array,
#: before any trace tail).
_HIER_TAIL = struct.Struct("<ddB")  # tenant_a, tenant_b, priority
HIER_TAIL_LEN = _HIER_TAIL.size

#: OP_STATS flag bits (the optional one-byte payload): bit 0 resets the
#: serving/stage latency windows after the snapshot; bit 1 asks the
#: flight recorder for an explicit JSONL dump (the ``OP_SAVE``-style
#: operator trigger — the dump path comes back in the stats payload).
STATS_FLAG_RESET = 1
STATS_FLAG_FLIGHT_DUMP = 2

_OP_NAMES = {
    OP_ACQUIRE: "acquire",
    OP_PEEK: "peek",
    OP_SYNC: "sync_counter",
    OP_WINDOW: "window_acquire",
    OP_PING: "ping",
    OP_SAVE: "save",
    OP_STATS: "stats",
    OP_SEMA: "sema",
    OP_FWINDOW: "fixed_window_acquire",
    OP_HELLO: "hello",
    OP_ACQUIRE_MANY: "acquire_many",
    OP_METRICS: "metrics",
    OP_TRACES: "traces",
    OP_PLACEMENT: "placement",
    OP_PLACEMENT_ANNOUNCE: "placement_announce",
    OP_MIGRATE_PULL: "migrate_pull",
    OP_MIGRATE_PUSH: "migrate_push",
    OP_CONFIG: "config",
    OP_ACQUIRE_H: "acquire_hierarchical",
    OP_RESERVE: "reserve",
    OP_SETTLE: "settle",
    OP_FED_LEASE: "fed_lease",
    OP_FED_RENEW: "fed_renew",
    OP_FED_RECLAIM: "fed_reclaim",
    OP_AUDIT: "audit",
}


def op_name(op: int) -> str:
    """Human-readable op name (used by the wire-level profiler)."""
    return _OP_NAMES.get(op, f"op{op}")


RESP_DECISION = 64
RESP_VALUE = 65
RESP_PAIR = 66
RESP_EMPTY = 67
RESP_TEXT = 68
RESP_BULK = 69
RESP_ERROR = 127

#: Upper bound on a frame body; a peer announcing more is protocol-broken
#: (or hostile) and the connection is dropped rather than buffered.
MAX_FRAME = 1 << 20

_HDR = struct.Struct("<IBIB")         # length covers [version][seq][op][payload]
_VER_SEQ_OP = struct.Struct("<BIB")
_BODY_OFF = _VER_SEQ_OP.size          # payload offset inside a frame body
_DECISION = struct.Struct("<Bd")
_VALUE = struct.Struct("<d")
_PAIR = struct.Struct("<dd")
_KEYED = struct.Struct("<H")
_TEXTLEN = struct.Struct("<I")
_ACQ_TAIL = struct.Struct("<idd")
_F64x2 = struct.Struct("<dd")


class RemoteStoreError(RuntimeError):
    """Server-side failure relayed to the client (≙ a Redis script error
    surfaced through ``ScriptEvaluateAsync``)."""


class ProtocolVersionError(RemoteStoreError):
    """Peer speaks a different protocol revision; the frame was not
    interpreted past its version byte."""


def _check_version(ver: int) -> None:
    if ver != PROTOCOL_VERSION:
        raise ProtocolVersionError(
            f"protocol version mismatch: peer speaks v{ver}, "
            f"this build speaks v{PROTOCOL_VERSION}"
        )


def _keyed(key: str, tail: bytes) -> bytes:
    # surrogateescape: byte-identity keys round-trip through str (the
    # serving side treats keys as bytes — see the ACQUIRE_MANY notes).
    kb = key.encode("utf-8", "surrogateescape")
    if len(kb) > 0xFFFF:
        raise ValueError("key exceeds 65535 utf-8 bytes")
    return _KEYED.pack(len(kb)) + kb + tail


def _split_key(payload: bytes) -> tuple[str, bytes]:
    (klen,) = _KEYED.unpack_from(payload, 0)
    # surrogateescape, matching _keyed: a byte-identity key admitted by
    # the bulk lane must round-trip through scalar ops (PEEK/SYNC/
    # single ACQUIRE) too, not error only there.
    key = payload[2:2 + klen].decode("utf-8", "surrogateescape")
    return key, payload[2 + klen:]


def _codepoint_truncate(mb: bytes, limit: int) -> bytes:
    """Truncate utf-8 bytes to ``limit`` on a codepoint boundary."""
    if len(mb) <= limit:
        return mb
    return mb[:limit].decode("utf-8", "ignore").encode("utf-8")


def encode_request(seq: int, op: int, key: str = "", count: int = 0,
                   a: float = 0.0, b: float = 0.0,
                   trace=None, deadline_s: "float | None" = None,
                   hier: "tuple[str, float, float, int] | None" = None,
                   attempt: int = 0) -> bytes:
    if op == OP_ACQUIRE_H:
        # Hierarchical acquire: the OP_ACQUIRE payload followed by the
        # tenant extension [u16 tlen][tenant][_HIER_TAIL]. `hier` is
        # (tenant, tenant_a, tenant_b, priority).
        if hier is None:
            raise ValueError("OP_ACQUIRE_H requires the tenant extension")
        tenant, ta, tb, priority = hier
        payload = (_keyed(key, _ACQ_TAIL.pack(count, a, b))
                   + _keyed(tenant, _HIER_TAIL.pack(ta, tb,
                                                    priority & 0xFF)))
    elif op in (OP_ACQUIRE, OP_WINDOW, OP_SEMA, OP_FWINDOW):
        payload = _keyed(key, _ACQ_TAIL.pack(count, a, b))
    elif op in (OP_PEEK, OP_SYNC):
        payload = _keyed(key, _F64x2.pack(a, b))
    elif op == OP_HELLO:
        payload = _keyed(key, b"")  # key carries the auth token
    elif op in (OP_STATS, OP_TRACES):
        # Optional one-byte flag bitmask. STATS (STATS_FLAG_*): bit 0
        # resets the serving/stage latency windows after snapshotting
        # (steady-state measurement), bit 1 triggers a flight-recorder
        # dump. TRACES: bit 0 drains the trace buffer after export.
        # Absent byte = plain snapshot/export.
        payload = bytes([count & 0xFF]) if count else b""
    elif op in TEXT_OPS:
        # Control-plane JSON rides in the key slot with the u32 length
        # prefix RESP_TEXT already uses (migration blobs outgrow the u16
        # keyed header); bounded by MAX_FRAME like every frame.
        mb = key.encode("utf-8")
        if _BODY_OFF + _TEXTLEN.size + len(mb) > MAX_FRAME:
            raise ValueError(
                f"control payload of {len(mb)} bytes exceeds MAX_FRAME; "
                "chunk the migration batch")
        payload = _TEXTLEN.pack(len(mb)) + mb
    elif op in (OP_PING, OP_SAVE, OP_METRICS, OP_PLACEMENT):
        payload = b""
    else:
        raise ValueError(f"unknown op {op}")
    if attempt:
        # Tail order is fixed: attempt first, then deadline, trace last
        # — the server strips trace (bit 7), then deadline (bit 6), then
        # attempt (bit 5). First attempts (attempt == 0) never stamp, so
        # the healthy path stays byte-identical to plain v4.
        op |= ATTEMPT_FLAG
        payload += _ATTEMPT_TAIL.pack(min(int(attempt), 0xFF))
    if deadline_s is not None:
        # Tail order is fixed: deadline first, trace last — the server
        # strips trace (bit 7), then deadline (bit 6). Frames without
        # either stay byte-identical to plain v4.
        op |= DEADLINE_FLAG
        payload += _DEADLINE_TAIL.pack(deadline_s)
    if trace is not None:
        # Sampled request: append the 25-byte trace tail and set the
        # op-byte flag. Untraced frames stay byte-identical to plain v4.
        op |= TRACE_FLAG
        payload += _TRACE_TAIL.pack(trace[0], trace[1], trace[2],
                                    trace[3] & 0xFF)
    return _HDR.pack(_BODY_OFF + len(payload), PROTOCOL_VERSION, seq, op) + payload


def strip_trace(body: bytes):
    """Split a scalar frame body's trace tail: returns ``(plain_body,
    TraceContext | None)`` where ``plain_body`` is byte-identical to the
    frame an untraced peer would have sent (op flag cleared, tail
    removed). The server calls this BEFORE :func:`decode_request`, which
    stays strict — on an old server the flagged op raises the routable
    "unknown op" error instead (never a misparse)."""
    if len(body) < _BODY_OFF or not body[5] & TRACE_FLAG:
        return body, None
    if len(body) < _BODY_OFF + TRACE_TAIL_LEN:
        raise RemoteStoreError("truncated trace tail")
    hi, lo, span, flags = _TRACE_TAIL.unpack_from(body,
                                                  len(body) - TRACE_TAIL_LEN)
    plain = (body[:5] + bytes([body[5] & ~TRACE_FLAG])
             + body[_BODY_OFF:len(body) - TRACE_TAIL_LEN])
    return plain, TraceContext(hi, lo, span, flags)


def strip_deadline(body: bytes) -> "tuple[bytes, float | None]":
    """Split a scalar frame body's deadline tail: ``(plain_body,
    deadline_s | None)``. Call AFTER :func:`strip_trace` (the trace tail
    rides last). Same strictness posture: an old server never reaches
    here — the flagged op raises its routable "unknown op" error."""
    if len(body) < _BODY_OFF or not body[5] & DEADLINE_FLAG:
        return body, None
    if len(body) < _BODY_OFF + DEADLINE_TAIL_LEN:
        raise RemoteStoreError("truncated deadline tail")
    (deadline_s,) = _DEADLINE_TAIL.unpack_from(
        body, len(body) - DEADLINE_TAIL_LEN)
    plain = (body[:5] + bytes([body[5] & ~DEADLINE_FLAG])
             + body[_BODY_OFF:len(body) - DEADLINE_TAIL_LEN])
    return plain, deadline_s


def strip_attempt(body: bytes) -> "tuple[bytes, int]":
    """Split a scalar frame body's attempt tail: ``(plain_body,
    attempt)`` — attempt 0 when the flag is clear (a first attempt, or
    a peer not speaking the dialect). Call AFTER :func:`strip_deadline`
    (the attempt tail is stamped first, so it sits innermost). Same
    strictness posture as the other tails: an old server never reaches
    here — the flagged op raises its routable "unknown op" error."""
    if len(body) < _BODY_OFF or not body[5] & ATTEMPT_FLAG:
        return body, 0
    if len(body) < _BODY_OFF + ATTEMPT_TAIL_LEN:
        raise RemoteStoreError("truncated attempt tail")
    (attempt,) = _ATTEMPT_TAIL.unpack_from(body,
                                           len(body) - ATTEMPT_TAIL_LEN)
    plain = (body[:5] + bytes([body[5] & ~ATTEMPT_FLAG])
             + body[_BODY_OFF:len(body) - ATTEMPT_TAIL_LEN])
    return plain, attempt


def decode_request(frame: bytes) -> tuple[int, int, str, int, float, float]:
    """Returns ``(seq, op, key, count, a, b)``."""
    ver, seq, op = _VER_SEQ_OP.unpack_from(frame, 0)
    _check_version(ver)
    body = frame[_BODY_OFF:]
    if op in (OP_ACQUIRE, OP_WINDOW, OP_SEMA, OP_FWINDOW):
        key, tail = _split_key(body)
        count, a, b = _ACQ_TAIL.unpack(tail)
        return seq, op, key, count, a, b
    if op in (OP_PEEK, OP_SYNC):
        key, tail = _split_key(body)
        a, b = _F64x2.unpack(tail)
        return seq, op, key, 0, a, b
    if op == OP_HELLO:
        token, _ = _split_key(body)
        return seq, op, token, 0, 0.0, 0.0
    if op in (OP_STATS, OP_TRACES):
        return seq, op, "", (body[0] if body else 0), 0.0, 0.0
    if op in TEXT_OPS:
        (mlen,) = _TEXTLEN.unpack_from(body, 0)
        return seq, op, body[4:4 + mlen].decode("utf-8"), 0, 0.0, 0.0
    if op in (OP_PING, OP_SAVE, OP_METRICS, OP_PLACEMENT):
        return seq, op, "", 0, 0.0, 0.0
    if op == OP_ACQUIRE_MANY:
        raise RemoteStoreError(
            "ACQUIRE_MANY frames decode via decode_bulk_request")
    if op == OP_ACQUIRE_H:
        raise RemoteStoreError(
            "ACQUIRE_H frames decode via decode_hierarchical_request")
    raise RemoteStoreError(f"unknown op {op}")


def decode_hierarchical_request(frame: bytes
                                ) -> tuple[int, str, int, float, float,
                                           str, float, float, int]:
    """Decode one OP_ACQUIRE_H frame body: returns ``(seq, key, count,
    a, b, tenant, tenant_a, tenant_b, priority)``. Strict like
    :func:`decode_request` — truncation raises the routable error, and
    the caller strips any deadline/trace tails first (the server does,
    in ``handle_frame_body``)."""
    ver, seq, op = _VER_SEQ_OP.unpack_from(frame, 0)
    _check_version(ver)
    if op != OP_ACQUIRE_H:
        raise RemoteStoreError(f"expected ACQUIRE_H, got op {op}")
    body = frame[_BODY_OFF:]
    key, tail = _split_key(body)
    if len(tail) < _ACQ_TAIL.size:
        raise RemoteStoreError("truncated ACQUIRE_H payload")
    count, a, b = _ACQ_TAIL.unpack_from(tail, 0)
    tenant, rest = _split_key(tail[_ACQ_TAIL.size:])
    if len(rest) != HIER_TAIL_LEN:
        raise RemoteStoreError("malformed ACQUIRE_H tenant extension")
    ta, tb, priority = _HIER_TAIL.unpack(rest)
    return seq, key, count, a, b, tenant, ta, tb, priority


def encode_response(seq: int, kind: int, *vals) -> bytes:
    if kind == RESP_DECISION:
        payload = _DECISION.pack(1 if vals[0] else 0, float(vals[1]))
    elif kind == RESP_VALUE:
        payload = _VALUE.pack(float(vals[0]))
    elif kind == RESP_PAIR:
        payload = _PAIR.pack(float(vals[0]), float(vals[1]))
    elif kind == RESP_EMPTY:
        payload = b""
    elif kind == RESP_ERROR:
        mb = _codepoint_truncate(str(vals[0]).encode("utf-8"), 0xFFFF)
        payload = _KEYED.pack(len(mb)) + mb
    elif kind == RESP_TEXT:
        # u32 length: a large payload (e.g. MeshBucketStore stats with many
        # tiers) must never be silently truncated into undecodable JSON —
        # oversize is a loud error instead, bounded by MAX_FRAME.
        mb = str(vals[0]).encode("utf-8")
        if _BODY_OFF + _TEXTLEN.size + len(mb) > MAX_FRAME:
            raise ValueError(
                f"text payload of {len(mb)} bytes exceeds MAX_FRAME"
            )
        payload = _TEXTLEN.pack(len(mb)) + mb
    else:
        raise ValueError(f"unknown response kind {kind}")
    return _HDR.pack(_BODY_OFF + len(payload), PROTOCOL_VERSION, seq, kind) + payload


def decode_response(frame: bytes) -> tuple[int, int, tuple]:
    """Returns ``(seq, kind, values)``; server-side failures travel as
    ``(RESP_ERROR, (message,))`` so the client can fail just that future.
    Raises only for protocol-level breakage (version mismatch)."""
    ver, seq, kind = _VER_SEQ_OP.unpack_from(frame, 0)
    _check_version(ver)
    body = frame[_BODY_OFF:]
    if kind == RESP_DECISION:
        granted, remaining = _DECISION.unpack(body)
        return seq, kind, (bool(granted), remaining)
    if kind == RESP_VALUE:
        return seq, kind, _VALUE.unpack(body)
    if kind == RESP_PAIR:
        return seq, kind, _PAIR.unpack(body)
    if kind == RESP_EMPTY:
        return seq, kind, ()
    if kind == RESP_ERROR:
        (mlen,) = _KEYED.unpack_from(body, 0)
        return seq, kind, (body[2:2 + mlen].decode("utf-8"),)
    if kind == RESP_TEXT:
        (mlen,) = _TEXTLEN.unpack_from(body, 0)
        return seq, kind, (body[4:4 + mlen].decode("utf-8"),)
    if kind == RESP_BULK:
        return seq, kind, _decode_bulk_response_body(body)
    raise RemoteStoreError(f"unknown response kind {kind}")


# -- bulk acquire (OP_ACQUIRE_MANY / RESP_BULK) -----------------------------

_BULK_REQ_HEAD = struct.Struct("<BddI")   # flags, capacity, fill_rate, n
_BULK_RESP_HEAD = struct.Struct("<BI")    # flags, n

#: Named head widths so the native bulk lane's C mirror (kBulkReqHead /
#: kBulkRespHead in frontend.cc) is diffable by drl-check — this module
#: stays the normative layout (docs/DESIGN.md §10).
BULK_REQ_HEAD_LEN = _BULK_REQ_HEAD.size
BULK_RESP_HEAD_LEN = _BULK_RESP_HEAD.size

#: Per-request wire overhead in an ACQUIRE_MANY frame: u16 klen + u32 count.
BULK_PER_KEY_OVERHEAD = 6
#: Default per-frame payload budget for client-side chunking — headroom
#: under MAX_FRAME for the frame header + bulk head.
BULK_CHUNK_BUDGET = MAX_FRAME - 64

_FLAG_WITH_REMAINING = 1

#: Bulk table kinds (flags bits 1-2): which table family decides the frame.
BULK_KIND_BUCKET = 0
BULK_KIND_WINDOW = 1
BULK_KIND_FWINDOW = 2
#: Hierarchical tenant → key buckets (runtime/admission.py): the frame
#: decides ONE tenant's rows — grant iff both the row's child bucket
#: and the shared parent tenant bucket admit. Carries the tenant
#: extension ``[u16 tlen][tenant][_HIER_TAIL]`` after the counts array
#: (before any trace tail; old decoders read arrays by explicit counts
#: and answer a routable "unknown bulk kind 3" error — never a
#: misparse; the C bulk fast lane's kind gate routes it to Python).
BULK_KIND_HBUCKET = 3
_KIND_SHIFT = 1
_KIND_MASK = 0b110
#: Flags bit 3: this frame is a continuation chunk of the immediately
#: preceding bulk frame on the connection — the server must decide it
#: AFTER that frame (duplicate keys spanning a chunk boundary keep request
#: order). Independent bulk frames (bit clear) run fully concurrent.
_FLAG_CHAINED = 0b1000


def bulk_chunk_spans(key_blob_lens: "np.ndarray",
                     budget: int | None = None) -> list[tuple[int, int]]:
    """Split a bulk call into contiguous ``[start, end)`` spans whose
    encoded ACQUIRE_MANY payloads each fit ``budget`` bytes (default
    :data:`BULK_CHUNK_BUDGET`, read at call time). Vectorized (cumsum +
    searchsorted per span) so a million-key bulk costs a handful of numpy
    ops, not a Python loop."""
    if budget is None:
        budget = BULK_CHUNK_BUDGET
    n = len(key_blob_lens)
    if n == 0:
        return []
    cum = np.cumsum(np.asarray(key_blob_lens, np.int64)
                    + BULK_PER_KEY_OVERHEAD)
    spans: list[tuple[int, int]] = []
    start, base = 0, 0
    while start < n:
        end = int(np.searchsorted(cum, base + budget, side="right"))
        if end == start:
            end = start + 1  # one oversized key still fits a frame alone
        spans.append((start, end))
        base = int(cum[end - 1])
        start = end
    return spans


def encode_bulk_request(seq: int, key_blobs: "Sequence[bytes]",
                        counts: "np.ndarray", capacity: float,
                        fill_rate: float, *,
                        with_remaining: bool = True,
                        kind: int = BULK_KIND_BUCKET,
                        chained: bool = False,
                        trace=None, hier=None,
                        deadline_s: "float | None" = None,
                        attempt: int = 0) -> bytes:
    """Encode one ACQUIRE_MANY frame from per-key byte blobs. A thin
    wrapper over :func:`encode_bulk_request_span` (ONE definition of the
    frame layout — the two entry points must stay wire-identical);
    ``kind`` selects the table family (bucket/window/fixed-window/
    hierarchical); for windows the (capacity, fill_rate) slots carry
    (limit, window_s); ``hier`` is the HBUCKET tenant extension
    ``(tenant, tenant_a, tenant_b, priority)``."""
    n = len(key_blobs)
    klens = np.fromiter((len(b) for b in key_blobs), np.int64, n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(klens, out=offsets[1:])
    return encode_bulk_request_span(
        seq, b"".join(key_blobs), offsets, klens,
        np.asarray(counts, np.uint32), 0, n, capacity, fill_rate,
        with_remaining=with_remaining, kind=kind, chained=chained,
        trace=trace, hier=hier, deadline_s=deadline_s, attempt=attempt)


def encode_bulk_request_span(seq: int, blob: bytes, offsets: "np.ndarray",
                             klens: "np.ndarray", counts: "np.ndarray",
                             start: int, end: int, capacity: float,
                             fill_rate: float, *,
                             with_remaining: bool = True,
                             kind: int = BULK_KIND_BUCKET,
                             chained: bool = False,
                             trace=None, hier=None,
                             deadline_s: "float | None" = None,
                             attempt: int = 0) -> bytes:
    """Encode one ACQUIRE_MANY chunk by SLICING a whole-call key blob —
    the client-side half of the zero-copy lane. ``_bulk_prepare`` joins
    and encodes the call's keys once; each chunk's payload is then two
    array casts and one bytes slice instead of a per-key join (the
    per-chunk ``b"".join(key_blobs[s:e])`` plus its length genexpr were
    the client's top profile entries at 131K keys/call). ``hier``
    (required iff ``kind == BULK_KIND_HBUCKET``) is the frame's tenant
    extension ``(tenant, tenant_a, tenant_b, priority)``."""
    n = end - start
    kl = klens[start:end]
    if n and int(kl.max()) > 0xFFFF:
        raise ValueError("key exceeds 65535 utf-8 bytes")
    if kind not in (BULK_KIND_BUCKET, BULK_KIND_WINDOW, BULK_KIND_FWINDOW,
                    BULK_KIND_HBUCKET):
        raise ValueError(f"unknown bulk kind {kind}")
    if (hier is not None) != (kind == BULK_KIND_HBUCKET):
        raise ValueError(
            "the tenant extension rides exactly the HBUCKET kind")
    flags = ((_FLAG_WITH_REMAINING if with_remaining else 0)
             | (kind << _KIND_SHIFT)
             | (_FLAG_CHAINED if chained else 0)
             | (BULK_FLAG_TRACED if trace is not None else 0)
             | (BULK_FLAG_DEADLINE if deadline_s is not None else 0))
    parts = [
        _BULK_REQ_HEAD.pack(flags, capacity, fill_rate, n),
        kl.astype("<u2").tobytes(),
        blob[offsets[start]:offsets[end]],
        np.asarray(counts[start:end], "<u4").tobytes(),
    ]
    if hier is not None:
        # Tenant extension AFTER the arrays (an old decoder reads them
        # by explicit counts and rejects the kind before reaching it),
        # BEFORE any trace tail (which always rides last).
        tenant, ta, tb, priority = hier
        parts.append(_keyed(tenant, _HIER_TAIL.pack(ta, tb,
                                                    priority & 0xFF)))
    if deadline_s is not None:
        # Deadline + attempt tail AFTER the tenant extension, BEFORE
        # any trace tail (which always rides last). Old decoders read
        # arrays by explicit counts and never reach it.
        parts.append(_BULK_DEADLINE_TAIL.pack(deadline_s,
                                              min(int(attempt), 0xFF)))
    if trace is not None:
        # The trace tail rides AFTER the arrays: an old decoder reads
        # them by explicit counts and never touches it.
        parts.append(_TRACE_TAIL.pack(trace[0], trace[1], trace[2],
                                      trace[3] & 0xFF))
    payload = b"".join(parts)
    length = _BODY_OFF + len(payload)
    if length > MAX_FRAME:
        raise ValueError(
            f"bulk frame of {length} bytes exceeds MAX_FRAME; chunk the "
            "call with bulk_chunk_spans()"
        )
    return _HDR.pack(length, PROTOCOL_VERSION, seq, OP_ACQUIRE_MANY) + payload


def decode_bulk_request(frame: bytes, *, as_view: bool = False
                        ) -> tuple[int, "list[str] | KeyBlob", "np.ndarray",
                                   float, float, bool, int]:
    """Returns ``(seq, keys, counts[i64], a, b, with_remaining, kind)``.

    ``as_view=True`` returns the keys as a :class:`KeyBlob` instead of a
    list — the server's hot path, where a device-backed store resolves
    keys straight from the blob in native code and Python never
    materializes per-key strings."""
    ver, seq, op = _VER_SEQ_OP.unpack_from(frame, 0)
    _check_version(ver)
    if op != OP_ACQUIRE_MANY:
        raise RemoteStoreError(f"expected ACQUIRE_MANY, got op {op}")
    body = frame[_BODY_OFF:]
    flags, capacity, fill_rate, n = _BULK_REQ_HEAD.unpack_from(body, 0)
    off = _BULK_REQ_HEAD.size
    klens = np.frombuffer(body, "<u2", n, off).astype(np.int64)
    off += 2 * n
    total = int(klens.sum())
    blob = body[off:off + total]
    if len(blob) != total:
        raise RemoteStoreError("truncated ACQUIRE_MANY key blob")
    counts = np.frombuffer(body, "<u4", n, off + total).astype(np.int64)
    if as_view:
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(klens, out=offsets[1:])
        keys: "list[str] | KeyBlob" = KeyBlob(blob, offsets)
    else:
        # surrogateescape, like the view's lazy decode: the documented
        # contract is byte-identity keys on every lane — the two decode
        # modes must not disagree about which frames are valid.
        keys = decode_key_blob(blob, klens, errors="surrogateescape")
    kind = (flags & _KIND_MASK) >> _KIND_SHIFT
    if kind not in (BULK_KIND_BUCKET, BULK_KIND_WINDOW, BULK_KIND_FWINDOW,
                    BULK_KIND_HBUCKET):
        # Unreachable while the 2-bit kind field stays fully assigned —
        # kept so narrowing the assignment can never silently misparse.
        raise RemoteStoreError(f"unknown bulk kind {kind}")
    return (seq, keys, counts, capacity, fill_rate,
            bool(flags & _FLAG_WITH_REMAINING), kind)


def bulk_request_chained(body: bytes) -> bool:
    """Peek a bulk frame body's chained bit (the server's dispatch gate —
    cheaper than a full decode). A truncated frame reads unchained; the
    full decode raises the routable error for it."""
    return len(body) > _BODY_OFF and bool(body[_BODY_OFF] & _FLAG_CHAINED)


def bulk_trace_tail(body: bytes) -> "TraceContext | None":
    """Read an ACQUIRE_MANY frame body's trace tail (flags bit 4), or
    ``None`` when absent. The tail sits at the very end of the payload;
    :func:`decode_bulk_request` reads its arrays by explicit counts, so
    the same frame decodes identically with the tail present — the
    old-peer compatibility property the fuzz tests pin down."""
    if (len(body) <= _BODY_OFF + TRACE_TAIL_LEN
            or not body[_BODY_OFF] & BULK_FLAG_TRACED):
        return None
    hi, lo, span, flags = _TRACE_TAIL.unpack_from(body,
                                                  len(body) - TRACE_TAIL_LEN)
    return TraceContext(hi, lo, span, flags)


def bulk_deadline_tail(body: bytes) -> "tuple[float, int] | None":
    """Read an ACQUIRE_MANY frame body's deadline + attempt tail (flags
    bit 5): ``(deadline_s, attempt)``, or ``None`` when absent. The
    tail rides immediately BEFORE any trace tail, so it parses from the
    end like :func:`bulk_trace_tail`; :func:`decode_bulk_request` reads
    its arrays by explicit counts, so the same frame decodes
    identically with the tail present — no old-peer latch on the bulk
    lane, same as traced bulk frames."""
    if (len(body) <= _BODY_OFF + BULK_DEADLINE_TAIL_LEN
            or not body[_BODY_OFF] & BULK_FLAG_DEADLINE):
        return None
    end = len(body)
    if body[_BODY_OFF] & BULK_FLAG_TRACED:
        end -= TRACE_TAIL_LEN
    if end - BULK_DEADLINE_TAIL_LEN < _BODY_OFF:
        raise RemoteStoreError("truncated bulk deadline tail")
    deadline_s, attempt = _BULK_DEADLINE_TAIL.unpack_from(
        body, end - BULK_DEADLINE_TAIL_LEN)
    return deadline_s, attempt


def bulk_hier_tail(body: bytes) -> tuple[str, float, float, int]:
    """Parse an HBUCKET ACQUIRE_MANY frame body's tenant extension:
    ``(tenant, tenant_a, tenant_b, priority)``. The extension sits at a
    FIXED offset — right after the counts array, before any trace tail
    — so it parses forward (the trace tail still parses from the end,
    :func:`bulk_trace_tail`). Truncation raises the routable error; the
    arrays themselves were already validated by
    :func:`decode_bulk_request`."""
    flags, _a, _b, n = _BULK_REQ_HEAD.unpack_from(body, _BODY_OFF)
    off = _BODY_OFF + _BULK_REQ_HEAD.size
    klens = np.frombuffer(body, "<u2", n, off)
    off += 2 * n + int(klens.astype(np.int64).sum()) + 4 * n
    if len(body) < off + _KEYED.size:
        raise RemoteStoreError("truncated HBUCKET tenant extension")
    (tlen,) = _KEYED.unpack_from(body, off)
    off += _KEYED.size
    if len(body) < off + tlen + HIER_TAIL_LEN:
        raise RemoteStoreError("truncated HBUCKET tenant extension")
    tenant = body[off:off + tlen].decode("utf-8", "surrogateescape")
    ta, tb, priority = _HIER_TAIL.unpack_from(body, off + tlen)
    return tenant, ta, tb, priority


class KeyBlob:
    """Zero-copy view of a bulk frame's keys: the concatenated utf-8
    blob plus ``i64[n+1]`` boundary offsets. The serving path hands this
    straight to the native key directory (``dir_resolve_batch`` probes
    the blob in C), so a 100K-key frame costs ZERO Python string
    objects on the device-store hot path. Sequence duck-typing
    (``len``/iteration/indexing, decoding lazily with surrogateescape —
    the same stable-identity-for-any-bytes rule as the native
    front-end's batch lane) keeps every other store working unchanged:
    serial stores just iterate it like the list they used to get."""

    __slots__ = ("blob", "offsets")

    def __init__(self, blob: bytes, offsets: "np.ndarray") -> None:
        self.blob = blob
        # Contiguous i64 is a hard requirement: four native lanes
        # reinterpret this buffer as int64* — a stray int32/strided
        # array would read garbage offsets in C (no Python-level error).
        self.offsets = np.ascontiguousarray(offsets, np.int64)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> str:
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self.blob[self.offsets[i]:self.offsets[i + 1]].decode(
            "utf-8", "surrogateescape")

    def __iter__(self):
        o = self.offsets.tolist()
        blob = self.blob
        for s, e in zip(o, o[1:]):
            yield blob[s:e].decode("utf-8", "surrogateescape")

    def tolist(self) -> list[str]:
        return decode_key_blob(self.blob,
                               np.diff(self.offsets),
                               errors="surrogateescape")


def decode_key_blob(blob: bytes, klens: "np.ndarray", *,
                    errors: str = "strict") -> list[str]:
    """Split a concatenated key blob into strings by per-key lengths —
    one decode for the whole blob on the (overwhelming) ascii fast path.
    Shared by the bulk-frame decoder and the native front-end's batch
    handoff — both pass ``errors="surrogateescape"`` (byte-identity
    keys: a hostile key rate-limits under its own stable identity
    rather than poisoning its batch)."""
    ends = np.cumsum(np.asarray(klens, np.int64))
    starts = ends - klens
    if blob.isascii():
        text = blob.decode("ascii")
        return [text[s:e] for s, e in zip(starts.tolist(), ends.tolist())]
    return [blob[s:e].decode("utf-8", errors)
            for s, e in zip(starts.tolist(), ends.tolist())]


def encode_bulk_response(seq: int, granted: "np.ndarray",
                         remaining: "np.ndarray | None") -> bytes:
    n = len(granted)
    flags = 0 if remaining is None else _FLAG_WITH_REMAINING
    parts = [
        _BULK_RESP_HEAD.pack(flags, n),
        np.packbits(np.asarray(granted, bool), bitorder="little").tobytes(),
    ]
    if remaining is not None:
        parts.append(np.asarray(remaining, "<f4").tobytes())
    payload = b"".join(parts)
    return _HDR.pack(_BODY_OFF + len(payload), PROTOCOL_VERSION, seq,
                     RESP_BULK) + payload


def _decode_bulk_response_body(body: bytes) -> tuple["np.ndarray",
                                                     "np.ndarray | None"]:
    flags, n = _BULK_RESP_HEAD.unpack_from(body, 0)
    off = _BULK_RESP_HEAD.size
    nbits = (n + 7) // 8
    granted = np.unpackbits(
        np.frombuffer(body, np.uint8, nbits, off), bitorder="little",
    )[:n].astype(bool)
    remaining = None
    if flags & _FLAG_WITH_REMAINING:
        remaining = np.frombuffer(body, "<f4", n, off + nbits).astype(
            np.float32)
    return granted, remaining


async def read_frame(reader) -> bytes | None:
    """Read one ``[version][seq][op][payload]`` body; ``None`` on clean
    EOF."""
    import asyncio

    try:
        hdr = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = struct.unpack("<I", hdr)
    if not _BODY_OFF <= length <= MAX_FRAME:
        raise RemoteStoreError(f"bad frame length {length}")
    try:
        return await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None


def write_frame(writer, data: bytes) -> None:
    writer.write(data)
