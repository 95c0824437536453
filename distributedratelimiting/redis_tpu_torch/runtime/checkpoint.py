"""Planned-restart checkpoints on disk: the JAX package's
``runtime/checkpoint.py`` on the port, in the same format.

The store's device tables ARE the store, so planned restarts snapshot
``(keys, tokens, ts)`` to a file and restore re-aligns every timestamp to
the new process's clock epoch (``BucketStore.snapshot``/``restore`` do the
pulling and re-alignment; this module only adds the durable file form).
Crash recovery deliberately stays init-on-miss — wiped state self-heals to
"full bucket".

Full files (v3, shared with the JAX package): one pickle (protocol 5 —
numpy arrays serialize as raw buffers) of ``{"magic", "version", "crc32",
"snapshot_pickle"[, "placement_epoch"]}``, where ``snapshot_pickle`` is the
store's snapshot dict pickled on its own and ``crc32`` its CRC-32. Every
file is written atomically via temp-file + fsync + ``os.replace`` plus a
directory fsync, so a crash mid-write never leaves a torn file where the
previous checkpoint was; a torn or bit-flipped file raises the typed
:class:`SnapshotCorruptError`. Readers accept versions 1–3.

Incremental checkpoints (v4 deltas): :class:`SnapshotChain` layers a delta
chain on the v3 base. Each save diffs the live state against the
previously saved state (a structural diff — per slot for device arrays,
per key for host dicts) and writes only the changes to
``<path>.delta.<seq>``. The chain is bounded (``max_chain``, and a delta
approaching ``compact_ratio`` of the base's size compacts into a fresh
base) and every link is integrity-chained: the base's CRC, the previous
link's CRC, a contiguous ``seq`` and its own CRC-32, so a truncated delta, a
missing base, a corrupt middle link or a stale link raises the typed
:class:`SnapshotChainError`, a :class:`SnapshotCorruptError`, which every
init-on-miss fallback already handles. Placement epochs stamp every link; a
mixed-epoch chain is a :class:`PlacementMismatchError` before any state is
restored. :func:`load_snapshot_chain` restores a base and its deltas.

A base plus deltas written by either package loads into the other
package's store of the same kind.
"""

from __future__ import annotations

import glob
import os
import pickle
import tempfile
import zlib

import numpy as np

__all__ = ["save_snapshot", "load_snapshot", "load_snapshot_chain",
           "SnapshotChain", "SnapshotCorruptError", "SnapshotChainError",
           "PlacementMismatchError", "diff_snapshot",
           "apply_snapshot_delta"]

_MAGIC = "drl-tpu-snapshot"
_VERSION = 3
_COMPAT = frozenset({1, 2, 3})

#: Unpickling failure modes a torn/corrupt file produces. AttributeError/
#: ImportError cover a payload whose pickled class moved or never existed
#: (bit flips in the class name land here); ValueError covers truncated
#: numpy buffer reconstruction.
_UNPICKLE_ERRORS = (pickle.UnpicklingError, EOFError, AttributeError,
                    ImportError, IndexError, ValueError)


class SnapshotCorruptError(ValueError):
    """The checkpoint file is torn or corrupt (truncated write, bit
    flip, checksum mismatch). Recovery: delete the file and restart —
    the store initializes empty and self-heals to full buckets, the
    documented init-on-miss posture. Subclasses :class:`ValueError` so
    pre-typed catches keep working."""


class SnapshotChainError(SnapshotCorruptError):
    """A delta chain link is unusable: truncated, checksum-bad, pointing
    at a different base, out of sequence, or stamped with a different
    placement epoch than its base. Recovery is the base's own posture:
    delete the ``.delta.*`` files (the base alone restores the state up
    to its save point) or delete everything and fall back to
    init-on-miss. Subclasses :class:`SnapshotCorruptError` so every
    existing fallback path already does the right thing."""


class PlacementMismatchError(SnapshotCorruptError):
    """The checkpoint was written under a different cluster placement
    epoch than the caller expects: its key memberships belong to a
    retired map, and restoring it would let a rejoining node serve (and
    double-admit) keys it no longer owns. Recovery is the same
    init-on-miss fallback as a torn file."""


def _atomic_write(path: str, payload: dict) -> None:
    """Temp file in the destination directory, fsync the data,
    ``os.replace`` into place, fsync the directory so the rename itself
    survives a crash — at no instant does a torn file sit where a
    checkpoint name points."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".snapshot-")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=5)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _full_payload(snap: dict, placement_epoch: "int | None") -> dict:
    snap_bytes = pickle.dumps(snap, protocol=5)
    payload = {
        "magic": _MAGIC,
        "version": _VERSION,
        "crc32": zlib.crc32(snap_bytes),
        "snapshot_pickle": snap_bytes,
    }
    if placement_epoch is not None:
        payload["placement_epoch"] = int(placement_epoch)
    return payload


def _retire_chain(path: str) -> None:
    """Unlink every ``.delta.<seq>`` link beside ``path`` BEFORE a full
    save replaces the base. Ordering matters: stale links beside a new
    base would be refused at load (base_crc mismatch) and drag the valid
    base down with them into init-on-miss; deleting first risks only a
    crash window that restores to the OLD base's save point — bounded
    staleness, never total loss."""
    for _seq, p in _chain_paths(path):
        try:
            os.unlink(p)
        except OSError:  # a racing cleanup is fine
            pass


def _snapshot_with_attachments(store) -> dict:
    """``store.snapshot()`` plus the store-attached control-plane state
    that must survive a planned restart: an ACTIVE federation ledger's
    lease state (runtime/federation.py) rides as its own ``"federation"``
    section — TTLs exported as remaining ages, so a restore can only
    shorten a lease's term (conservative, never extended). Non-home
    stores (no ledger, or a never-used one) keep their snapshot shape
    byte for byte, and the structural diff handles the extra dict section
    generically."""
    snap = store.snapshot()
    fed = getattr(store, "_federation", None)
    if fed is not None and fed.active:
        snap = dict(snap)
        snap["federation"] = fed.export_state()
    return snap


def _restore_with_attachments(store, snap: dict) -> None:
    """The restore half: route a ``"federation"`` section back into the
    store-attached ledger (created on demand) after the store body
    restores — the store's own ``restore`` never sees the attachment
    key."""
    fed_state = None
    if isinstance(snap, dict) and "federation" in snap:
        snap = dict(snap)
        fed_state = snap.pop("federation")
    store.restore(snap)
    if fed_state is not None:
        store.federation_ledger().restore_state(fed_state)


def save_snapshot(store, path: str,
                  placement_epoch: "int | None" = None) -> None:
    """Pull ``store``'s live state to the host and write it to ``path``
    atomically, retiring any delta chain beside it (a full save supersedes
    the chain). ``placement_epoch`` stamps the cluster placement epoch the
    state was owned under, so a later restore can be held to it.
    Store-attached federation lease state rides along
    (:func:`_snapshot_with_attachments`)."""
    payload = _full_payload(_snapshot_with_attachments(store),
                            placement_epoch)
    _retire_chain(path)
    _atomic_write(path, payload)


def load_snapshot(store, path: str,
                  expected_placement_epoch: "int | None" = None) -> None:
    """Restore ``store`` from a checkpoint file written by
    :func:`save_snapshot` (of either package). Timestamps re-align to this
    process's clock epoch inside ``store.restore``. Only load files you
    wrote — the format is pickle (a trusted-operator checkpoint, not an
    interchange format).

    ``expected_placement_epoch`` holds the file to a cluster placement
    epoch: a mismatch (including a file with no recorded epoch) raises
    :class:`PlacementMismatchError` before any state reaches the store.

    Raises :class:`SnapshotCorruptError` for a torn or bit-flipped file
    and plain :class:`ValueError` for a file that is not a snapshot or
    speaks an unknown newer version."""
    snap, _crc = _read_full(path, expected_placement_epoch)
    _restore_with_attachments(store, snap)


def _read_full(path: str,
               expected_placement_epoch: "int | None" = None
               ) -> "tuple[dict, int]":
    """Read + validate a full checkpoint; returns ``(snapshot,
    crc32-of-snapshot-bytes)`` (the crc is the delta chain's base
    identity; 0 for a v1/v2 file, which has none)."""
    with open(path, "rb") as f:
        try:
            payload = pickle.load(f)
        except _UNPICKLE_ERRORS as exc:
            raise SnapshotCorruptError(
                f"{path} is torn or corrupt ({exc!r}); delete it to fall "
                "back to init-on-miss (state self-heals to full buckets)"
            ) from exc
    if not isinstance(payload, dict) or payload.get("magic") != _MAGIC:
        raise ValueError(f"{path} is not a rate-limiter snapshot")
    if payload.get("version") not in _COMPAT:
        raise ValueError(
            f"snapshot version {payload.get('version')} not supported "
            f"(this build reads {sorted(_COMPAT)})"
        )
    if expected_placement_epoch is not None:
        recorded = payload.get("placement_epoch")
        if recorded != expected_placement_epoch:
            raise PlacementMismatchError(
                f"{path} was written under placement epoch {recorded} "
                f"but the cluster is at epoch {expected_placement_epoch}"
                "; its key memberships are stale — delete it to fall "
                "back to init-on-miss")
    if "snapshot_pickle" in payload:  # v3: verify before unpickling
        blob = payload["snapshot_pickle"]
        crc = zlib.crc32(blob)
        if crc != payload.get("crc32"):
            raise SnapshotCorruptError(
                f"{path} failed its checksum (crc32 {crc:#010x} != "
                f"recorded {payload.get('crc32', 0):#010x}); delete it "
                "to fall back to init-on-miss")
        try:
            snap = pickle.loads(blob)
        except _UNPICKLE_ERRORS as exc:  # the crc catches nearly all
            raise SnapshotCorruptError(
                f"{path} snapshot body is corrupt ({exc!r})") from exc
        return snap, crc
    # v1/v2: the state rides in the outer pickle, no checksum
    if "snapshot" not in payload:
        raise SnapshotCorruptError(
            f"{path} carries neither a v3 snapshot body nor a "
            "v1/v2 'snapshot' section")
    return payload["snapshot"], 0


# -- v4 incremental deltas ---------------------------------------------------
#
# A delta node is a tagged dict describing how to turn the PREVIOUSLY
# SAVED value into the current one:
#   {"t": "full", "v": value}              replace outright
#   {"t": "dict", "set": {k: node}, "del": [k, …]}   patch a mapping
#   {"t": "arr", "n": N, "idx": i64[], "val": values[]}  scatter into a
#       1-D array (rows beyond the previous length default to the
#       dtype's zero — device tables grow by doubling with zeroed
#       columns, and every genuinely-live new row is in idx anyway)
# The diff is generic over the snapshot schema — host-dict stores delta
# per key, device stores per slot — so every BucketStore gets incremental
# checkpoints with no per-store format code. A delta pickles dicts, tuples
# of str/float/int/bool, Python scalars and numpy arrays only (no class of
# either package), so either package loads the other's chain.

def _diff_node(base, curr):
    """Delta node turning ``base`` into ``curr``, or ``None`` when they
    are equal (the subtree is omitted from the delta entirely)."""
    if isinstance(base, dict) and isinstance(curr, dict):
        set_: dict = {}
        deleted = [k for k in base if k not in curr]
        for k, cv in curr.items():
            if k in base:
                sub = _diff_node(base[k], cv)
                if sub is not None:
                    set_[k] = sub
            else:
                set_[k] = {"t": "full", "v": cv}
        if not set_ and not deleted:
            return None
        return {"t": "dict", "set": set_, "del": deleted}
    if isinstance(base, np.ndarray) and isinstance(curr, np.ndarray):
        if (base.dtype == curr.dtype and base.ndim == curr.ndim == 1
                and len(curr) >= len(base)):
            m = len(base)
            changed = np.ones(len(curr), bool)
            if m:
                changed[:m] = curr[:m] != base
            idx = np.nonzero(changed)[0]
            if len(idx) == 0:
                return None
            # A near-total rewrite serializes smaller as the raw array
            # (no index vector); the chain's size threshold still sees
            # the true cost either way.
            if len(idx) * 2 >= len(curr):
                return {"t": "full", "v": curr}
            return {"t": "arr", "n": len(curr),
                    "idx": idx.astype(np.int64), "val": curr[idx]}
        if np.array_equal(base, curr):
            return None
        return {"t": "full", "v": curr}
    try:
        same = bool(base == curr)
    # Equality here is an OPTIMIZATION probe, not a failure path: a leaf
    # type that won't compare (or compares ambiguously, e.g. an array
    # that slipped past the ndarray branch) is simply carried whole.
    # drl-check: ok(swallowed-exception)
    except Exception:
        same = False
    return None if same else {"t": "full", "v": curr}


def _apply_node(base, node):
    t = node["t"]
    if t == "full":
        return node["v"]
    if t == "dict":
        if not isinstance(base, dict):
            raise SnapshotChainError(
                "delta patches a mapping the base does not carry — the "
                "chain does not belong to this base")
        out = dict(base)
        for k in node["del"]:
            out.pop(k, None)
        for k, sub in node["set"].items():
            out[k] = _apply_node(out.get(k), sub)
        return out
    if t == "arr":
        if not isinstance(base, np.ndarray):
            raise SnapshotChainError(
                "delta scatters into an array the base does not carry "
                "— the chain does not belong to this base")
        n = int(node["n"])
        val = np.asarray(node["val"])
        idx = np.asarray(node["idx"], np.int64)
        if len(idx) != len(val) or (len(idx)
                                    and int(idx.max(initial=0)) >= n):
            raise SnapshotChainError("delta scatter indices are corrupt")
        out = np.zeros(n, val.dtype)
        m = min(len(base), n)
        out[:m] = base[:m]
        out[idx] = val
        return out
    raise SnapshotChainError(f"unknown delta node tag {t!r}")


def diff_snapshot(base: dict, curr: dict) -> dict:
    """Structural diff of two store snapshots (see the node grammar
    above). ``{}`` when nothing changed."""
    return _diff_node(base, curr) or {}


def apply_snapshot_delta(base: dict, delta: dict) -> dict:
    """Replay one delta onto a reconstructed snapshot state."""
    if not delta:
        return base
    out = _apply_node(base, delta)
    if not isinstance(out, dict):
        raise SnapshotChainError("delta did not produce a snapshot dict")
    return out


_DELTA_VERSION = 4


def _delta_path(path: str, seq: int) -> str:
    return f"{path}.delta.{seq}"


def _chain_paths(path: str) -> "list[tuple[int, str]]":
    out = []
    for p in glob.glob(glob.escape(path) + ".delta.*"):
        tail = p.rsplit(".", 1)[-1]
        if tail.isdigit():
            out.append((int(tail), p))
    return sorted(out)


def _read_delta(path: str) -> dict:
    """Read + validate one delta link's envelope (not its chain
    position — :func:`load_snapshot_chain` owns that)."""
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
    except OSError as exc:
        raise SnapshotChainError(
            f"{path} is unreadable ({exc!r})") from exc
    except _UNPICKLE_ERRORS as exc:
        raise SnapshotChainError(
            f"{path} is torn or corrupt ({exc!r}); delete the .delta.* "
            "files to restore from the base alone") from exc
    if not isinstance(payload, dict) or payload.get("magic") != _MAGIC \
            or payload.get("version") != _DELTA_VERSION:
        raise SnapshotChainError(
            f"{path} is not a v{_DELTA_VERSION} snapshot delta")
    blob = payload.get("delta_pickle", b"")
    crc = zlib.crc32(blob)
    if crc != payload.get("crc32"):
        raise SnapshotChainError(
            f"{path} failed its checksum (crc32 {crc:#010x} != recorded "
            f"{payload.get('crc32', 0):#010x}); delete the .delta.* "
            "files to restore from the base alone")
    try:
        payload["delta"] = pickle.loads(blob)
    except _UNPICKLE_ERRORS as exc:  # pragma: no cover — crc catches
        raise SnapshotChainError(
            f"{path} delta body is corrupt ({exc!r})") from exc
    return payload


def load_snapshot_chain(store, path: str,
                        expected_placement_epoch: "int | None" = None
                        ) -> int:
    """Restore ``store`` from a base checkpoint plus its delta chain
    (``<path>.delta.1 … .delta.K``). With no delta files this is exactly
    :func:`load_snapshot`. Returns the number of deltas applied.

    Chain validation happens BEFORE any state reaches the store: links
    must be contiguous from 1, each must name the base's CRC and the
    previous link's CRC, and each must carry the same placement epoch
    as the caller expects of the base. Any violation raises the typed
    :class:`SnapshotChainError` (a :class:`SnapshotCorruptError`), so
    every existing init-on-miss fallback handles a broken chain the
    way it handles a torn base."""
    links = _chain_paths(path)
    try:
        snap, base_crc = _read_full(path, expected_placement_epoch)
    except OSError as exc:
        if links:
            # Deltas with no base are unusable by construction — the
            # typed error (not a bare FileNotFoundError) so the caller's
            # init-on-miss fallback handles a half-deleted chain the way
            # it handles a torn file.
            raise SnapshotChainError(
                f"{path} is missing but {len(links)} .delta.* file(s) "
                f"remain ({exc!r}); delete them to fall back to "
                "init-on-miss") from exc
        raise
    payloads = []
    prev_crc = base_crc
    for i, (seq, p) in enumerate(links, start=1):
        if seq != i:
            raise SnapshotChainError(
                f"delta chain for {path} is missing link {i} (found "
                f"seq {seq}); delete the .delta.* files to restore "
                "from the base alone")
        payload = _read_delta(p)
        if payload.get("base_crc") != base_crc:
            raise SnapshotChainError(
                f"{p} belongs to a different base (base_crc "
                f"{payload.get('base_crc', 0):#010x} != "
                f"{base_crc:#010x}); stale leftovers from an older "
                "chain — delete the .delta.* files")
        if payload.get("prev_crc") != prev_crc:
            raise SnapshotChainError(
                f"{p} does not chain to its predecessor (prev_crc "
                "mismatch); a middle link was replaced or lost — "
                "delete the .delta.* files")
        if expected_placement_epoch is not None and \
                payload.get("placement_epoch") != expected_placement_epoch:
            raise PlacementMismatchError(
                f"{p} was written under placement epoch "
                f"{payload.get('placement_epoch')} but the cluster is "
                f"at epoch {expected_placement_epoch}; delete it to "
                "fall back to init-on-miss")
        prev_crc = payload["crc32"]
        payloads.append(payload)
    for payload in payloads:
        snap = apply_snapshot_delta(snap, payload["delta"])
    _restore_with_attachments(store, snap)
    return len(payloads)


class SnapshotChain:
    """Incremental-checkpoint writer: owns one base + bounded delta
    chain at ``path`` (the server holds one per snapshot path). Each
    :meth:`save` diffs the live state against the PREVIOUS save and
    writes only the changes; the chain compacts into a fresh base when
    it grows past ``max_chain`` links, when a delta's size approaches
    ``compact_ratio`` of the base's, or when the placement epoch moved
    (a chain must be single-epoch — the load gate refuses mixtures).
    Every file goes through the same atomic temp+fsync+replace
    discipline as a full save."""

    def __init__(self, path: str, *, max_chain: int = 8,
                 compact_ratio: float = 0.5) -> None:
        self.path = path
        self.max_chain = max(1, int(max_chain))
        self.compact_ratio = float(compact_ratio)
        self._prev_snap: "dict | None" = None
        self._base_crc = 0
        self._base_bytes = 0
        self._prev_crc = 0
        self._seq = 0
        self._epoch: "int | None" = None
        self.full_saves = 0
        self.delta_saves = 0
        self.last_delta_bytes = 0

    def save(self, store, placement_epoch: "int | None" = None) -> str:
        """One checkpoint: a delta when a base is held and the chain has
        room, else a compacting full save. Returns the file written.
        Store-attached federation lease state rides every link
        (:func:`_snapshot_with_attachments` — the structural diff treats
        the section like any other dict)."""
        snap = _snapshot_with_attachments(store)
        mark = getattr(store, "mark_snapshot_base", None)
        if callable(mark):
            mark()  # reset the store's dirty accounting window
        if (self._prev_snap is None or self._seq >= self.max_chain
                or self._epoch != placement_epoch):
            return self._save_full(snap, placement_epoch)
        delta = diff_snapshot(self._prev_snap, snap)
        blob = pickle.dumps(delta, protocol=5)
        if len(blob) >= self.compact_ratio * max(1, self._base_bytes):
            return self._save_full(snap, placement_epoch)
        payload = {
            "magic": _MAGIC,
            "version": _DELTA_VERSION,
            "base_crc": self._base_crc,
            "prev_crc": self._prev_crc,
            "seq": self._seq + 1,
            "crc32": zlib.crc32(blob),
            "delta_pickle": blob,
        }
        if placement_epoch is not None:
            payload["placement_epoch"] = int(placement_epoch)
        path = _delta_path(self.path, self._seq + 1)
        _atomic_write(path, payload)
        self._seq += 1
        self._prev_crc = payload["crc32"]
        self._prev_snap = snap
        self.delta_saves += 1
        self.last_delta_bytes = len(blob)
        return path

    def _save_full(self, snap: dict, placement_epoch: "int | None") -> str:
        payload = _full_payload(snap, placement_epoch)
        # Links first, base second (see _retire_chain): a crash between
        # the two restores the OLD base's save point; the other order
        # leaves a new base with foreign links — refused wholesale at
        # load, i.e. total state loss from our own leftovers.
        _retire_chain(self.path)
        _atomic_write(self.path, payload)
        self._prev_snap = snap
        self._base_crc = payload["crc32"]
        self._base_bytes = len(payload["snapshot_pickle"])
        self._prev_crc = payload["crc32"]
        self._seq = 0
        self._epoch = placement_epoch
        self.full_saves += 1
        self.last_delta_bytes = 0
        return self.path

    def stats(self) -> dict:
        return {"chain_len": self._seq,
                "full_saves": self.full_saves,
                "delta_saves": self.delta_saves,
                "last_delta_bytes": self.last_delta_bytes,
                "base_bytes": self._base_bytes}

