"""Planned-restart checkpoints on disk: the full-file half of the JAX
package's ``runtime/checkpoint.py``, in the same format.

The store's device tables ARE the store, so planned restarts snapshot
``(keys, tokens, ts)`` to a file and restore re-aligns every timestamp to
the new process's clock epoch (``DeviceBucketStore.snapshot``/``restore``
do the pulling and re-alignment; this module only adds the durable file
form). Crash recovery deliberately stays init-on-miss — wiped state
self-heals to "full bucket".

Format (v3, shared with the JAX package: a file either package writes
loads into the other's store): one pickle (protocol 5 — numpy arrays
serialize as raw buffers) of ``{"magic", "version", "crc32",
"snapshot_pickle"[, "placement_epoch"]}``, where ``snapshot_pickle`` is the
store's snapshot dict pickled on its own and ``crc32`` its CRC-32. It is
written atomically via temp-file + fsync + ``os.replace`` plus a directory
fsync, so a crash mid-write never leaves a torn file where the previous
checkpoint was; a torn or bit-flipped file raises the typed
:class:`SnapshotCorruptError`. Readers accept versions 1–3.

Not ported yet: the incremental delta chain (``SnapshotChain``,
``load_snapshot_chain``), which needs dirty-slot tracking in the store. A
full save still removes any ``.delta.*`` links beside its path, as the JAX
package's does: a full save supersedes the chain.
"""

from __future__ import annotations

import glob
import os
import pickle
import tempfile
import zlib

__all__ = ["save_snapshot", "load_snapshot", "SnapshotCorruptError",
           "PlacementMismatchError"]

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
    """Unlink every ``.delta.<seq>`` link beside ``path`` before a full
    save replaces the base: stale links beside a new base would be refused
    at a chain-aware load and drag the valid base down with them."""
    for p in glob.glob(glob.escape(path) + ".delta.*"):
        if p.rsplit(".", 1)[-1].isdigit():
            try:
                os.unlink(p)
            except OSError:  # a racing cleanup is fine
                pass


def save_snapshot(store, path: str,
                  placement_epoch: "int | None" = None) -> None:
    """Pull ``store``'s live state to the host and write it to ``path``
    atomically. ``placement_epoch`` stamps the cluster placement epoch the
    state was owned under, so a later restore can be held to it."""
    payload = _full_payload(store.snapshot(), placement_epoch)
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
    store.restore(_read_full(path, expected_placement_epoch))


def _read_full(path: str,
               expected_placement_epoch: "int | None" = None) -> dict:
    """Read + validate a full checkpoint; returns the snapshot dict."""
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
        return snap
    # v1/v2: the state rides in the outer pickle, no checksum
    if "snapshot" not in payload:
        raise SnapshotCorruptError(
            f"{path} carries neither a v3 snapshot body nor a "
            "v1/v2 'snapshot' section")
    return payload["snapshot"]
