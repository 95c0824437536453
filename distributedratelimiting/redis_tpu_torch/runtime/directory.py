"""Key directory: the host-side ``(key string → device slot)`` map.

The per-key state lives in device slot arrays, so the routing map lives on
the host in front of them, and its per-flush batch resolve is on the serving
hot path. This is the JAX package's :class:`PyKeyDirectory` (dict +
free-list); its native C++ twin is not ported yet, so :func:`make_directory`
returns the Python one.

Semantics: slot ids pop in ascending order from a descending free-list;
``resolve_batch`` allocates on miss and returns ``-1`` once the free-list is
dry (the caller sweeps/grows and re-resolves); ``remove_slots`` evicts by
slot id and recycles LIFO; ``add_slots`` extends capacity after a table grow.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PyKeyDirectory", "make_directory"]


class PyKeyDirectory:
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
        # Freed slots are pushed in input order (LIFO reuse), so identical
        # op streams assign identical slot ids.
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
        """Adopt ``mapping`` wholesale; the free-list becomes every slot in
        ``[0, n_slots)`` the mapping does not use, popping in ascending
        order."""
        self._map = dict(mapping)
        used = set(self._map.values())
        self._free = [s for s in range(n_slots - 1, -1, -1) if s not in used]


def make_directory(n_slots: int) -> PyKeyDirectory:
    return PyKeyDirectory(n_slots)
