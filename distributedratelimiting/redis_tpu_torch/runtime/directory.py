"""Key directories: the host-side ``(key string → device slot)`` map.

The per-key state lives in device slot arrays, so the routing map lives on
the host in front of them, and its per-flush batch resolve is on the serving
hot path. Two interchangeable implementations, as in the JAX package:

- :class:`NativeKeyDirectory` — the C++ open-addressing table of
  ``native/directory.cc`` via ctypes (built by :mod:`..utils.native`): one C
  call resolves a whole flush, and removal by slot id reads a reverse index.
- :class:`PyKeyDirectory` — dict + free-list, semantically identical; the
  fallback when no compiler is available (``DRL_TPU_NO_NATIVE=1`` forces it).

:func:`make_directory` returns the native one whenever it builds.

Shared semantics (both backends, tested against each other and against the
JAX package's): slot ids pop in ascending order from a descending free-list;
``resolve_batch`` allocates on miss and returns ``-1`` once the free-list is
dry (the caller sweeps/grows and re-resolves); ``remove_slots`` evicts by
slot id and recycles LIFO; ``add_slots`` extends capacity after a table grow.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from distributedratelimiting.redis_tpu_torch.utils.native import (
    load_directory_lib,
)

__all__ = ["KeyDirectory", "PyKeyDirectory", "NativeKeyDirectory",
           "make_directory"]


class KeyDirectory:
    """Interface (duck-typed; both impls below)."""

    def resolve_batch(self, keys: list[str]) -> np.ndarray:  # i32[n]
        """``keys`` is a list of strings or a ``wire.KeyBlob`` (a bulk
        frame's key bytes): the native directory probes the blob in C, the
        Python one iterates it."""
        raise NotImplementedError

    def lookup(self, key: str) -> int | None:
        raise NotImplementedError

    def remove_slots(self, dead: "np.ndarray | list[int]") -> int:
        raise NotImplementedError

    def add_slots(self, start: int, end: int) -> None:
        raise NotImplementedError

    @property
    def free_count(self) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def to_dict(self) -> dict[str, int]:
        raise NotImplementedError

    def load(self, mapping: dict[str, int], n_slots: int) -> None:
        """Restore path: adopt ``mapping`` wholesale; the free-list becomes
        every slot in ``[0, n_slots)`` the mapping does not use, popping in
        ascending order."""
        raise NotImplementedError


class PyKeyDirectory(KeyDirectory):
    def __init__(self, n_slots: int) -> None:
        self._map: dict[str, int] = {}
        self._free: list[int] = list(range(n_slots - 1, -1, -1))

    def resolve_batch(self, keys: list[str]) -> np.ndarray:
        out = np.empty(len(keys), np.int32)
        get = self._map.get
        for i, k in enumerate(keys):
            slot = get(k)
            if slot is None:
                if not self._free:
                    out[i] = -1
                    continue
                slot = self._free.pop()
                self._map[k] = slot
            out[i] = slot
        return out

    def lookup(self, key: str) -> int | None:
        return self._map.get(key)

    def remove_slots(self, dead) -> int:
        # Freed slots are pushed in input order (LIFO reuse) — the native
        # free-list's discipline, so identical op streams assign identical
        # slot ids.
        rev = {s: k for k, s in self._map.items()}
        removed = 0
        for s in dead:
            k = rev.pop(int(s), None)
            if k is None:
                continue
            del self._map[k]
            self._free.append(int(s))
            removed += 1
        return removed

    def add_slots(self, start: int, end: int) -> None:
        self._free.extend(range(end - 1, start - 1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def __len__(self) -> int:
        return len(self._map)

    def to_dict(self) -> dict[str, int]:
        return dict(self._map)

    def load(self, mapping: dict[str, int], n_slots: int) -> None:
        self._map = dict(mapping)
        used = set(self._map.values())
        self._free = [s for s in range(n_slots - 1, -1, -1) if s not in used]


def _i32_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeKeyDirectory(KeyDirectory):
    """The C++ directory. Keys are stored as their UTF-8 bytes, with
    ``surrogateescape`` for byte-identity keys."""

    def __init__(self, n_slots: int, lib: ctypes.CDLL) -> None:
        self._lib = lib
        self._h = lib.dir_new(n_slots)
        if not self._h:
            raise MemoryError("dir_new failed")

    def __del__(self) -> None:
        h, self._h = getattr(self, "_h", None), None
        if h and getattr(self, "_lib", None) is not None:
            self._lib.dir_free(h)

    def resolve_batch(self, keys) -> np.ndarray:
        out = np.empty(len(keys), np.int32)
        blob = getattr(keys, "blob", None)
        if blob is not None:
            # Wire-blob fast path (wire.KeyBlob): the frame's key bytes
            # probe the table directly — no Python strings anywhere.
            self._lib.dir_resolve_batch(self._h, blob, _i64_ptr(keys.offsets),
                                        len(keys), _i32_ptr(out))
            return out
        if self._lib.has_pylist:
            # Zero-copy: C reads each str's cached UTF-8 directly.
            if not isinstance(keys, list):
                keys = list(keys)
            if self._lib.dir_resolve_pylist(self._h, keys, _i32_ptr(out)) >= 0:
                return out
            # A key C cannot read as UTF-8 (a lone surrogate) or a non-str:
            # the encode path below takes it, or raises the natural error.
        encoded = [k.encode("utf-8", "surrogateescape") for k in keys]
        offsets = np.zeros(len(keys) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        self._lib.dir_resolve_batch(self._h, b"".join(encoded),
                                    _i64_ptr(offsets), len(keys),
                                    _i32_ptr(out))
        return out

    def lookup(self, key: str) -> int | None:
        kb = key.encode("utf-8", "surrogateescape")
        slot = self._lib.dir_lookup(self._h, kb, len(kb))
        return None if slot < 0 else int(slot)

    def remove_slots(self, dead) -> int:
        arr = np.ascontiguousarray(
            dead if isinstance(dead, np.ndarray) else list(dead), np.int32)
        if arr.size == 0:
            return 0
        return int(self._lib.dir_remove_slots(self._h, _i32_ptr(arr),
                                              arr.size))

    def add_slots(self, start: int, end: int) -> None:
        self._lib.dir_add_slots(self._h, start, end)

    @property
    def free_count(self) -> int:
        return int(self._lib.dir_free_count(self._h))

    @property
    def arena_bytes(self) -> int:
        """Live key bytes (compaction keeps the real arena within 2× of
        this under churn)."""
        return int(self._lib.dir_arena_bytes(self._h))

    def __len__(self) -> int:
        return int(self._lib.dir_size(self._h))

    def to_dict(self) -> dict[str, int]:
        n = len(self)
        if n == 0:
            return {}
        keys_buf = ctypes.create_string_buffer(max(self.arena_bytes, 1))
        offsets = np.empty(n + 1, np.int64)
        slots = np.empty(n, np.int32)
        count = self._lib.dir_dump(self._h, keys_buf, _i64_ptr(offsets),
                                   _i32_ptr(slots))
        raw = keys_buf.raw
        return {
            raw[offsets[i]:offsets[i + 1]].decode("utf-8", "surrogateescape"):
                int(slots[i])
            for i in range(count)
        }

    def load(self, mapping: dict[str, int], n_slots: int) -> None:
        lib, h = self._lib, self._h
        self._h = None
        lib.dir_free(h)
        self._h = lib.dir_new(n_slots)
        for key, slot in mapping.items():
            kb = key.encode("utf-8", "surrogateescape")
            if lib.dir_insert(self._h, kb, len(kb), int(slot)) != 0:
                raise ValueError(f"duplicate key in restore mapping: {key!r}")
        used = np.zeros(n_slots, bool)
        used[np.fromiter(mapping.values(), np.int64, len(mapping))] = True
        free = np.arange(n_slots - 1, -1, -1, dtype=np.int32)
        free = np.ascontiguousarray(free[~used[free]])
        lib.dir_set_free(self._h, _i32_ptr(free), free.size)


def make_directory(n_slots: int) -> KeyDirectory:
    """Native if buildable, Python otherwise — transparently equivalent."""
    lib = load_directory_lib()
    if lib is not None:
        try:
            return NativeKeyDirectory(n_slots, lib)
        except Exception as exc:
            logging.getLogger(__name__).warning(
                "native key directory unavailable (%r); falling back to "
                "the Python directory", exc)
    return PyKeyDirectory(n_slots)
