"""The mesh: an ordered tuple of devices, one per shard.

The JAX package's ``parallel/mesh.py`` on PyTorch. JAX's ``Mesh`` is a 1-D
device array with one axis, ``"shard"``, over which the key dimension is
sharded; here a :class:`Mesh` is the ordered tuple of ``torch.device``\\ s
that hold the shards, in shard order. A device may repeat: the CPU tests run
8 shards on ``cpu`` (beside the JAX tests' 8 virtual CPU devices), and one
card holds every shard of a mesh in one shard-major table. A mesh whose
shards sit on more than one distinct device raises ``ValueError``: the
consumed totals would have to be gathered across cards, which the port does
not do yet (ROADMAP.md, Queue A, A 16).

JAX's ``shard_spec`` and ``replicated_spec`` (``NamedSharding`` helpers) and
its ``_shard_compat.py`` (the ``shard_map`` and ``pcast`` shims across jax
versions) have no counterpart: the port lays every shard out in one table
and needs no sharding annotations.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["SHARD_AXIS", "Mesh", "create_mesh"]

SHARD_AXIS = "shard"


class Mesh:
    """An ordered tuple of devices, one per shard (a device may repeat;
    every shard on one distinct device)."""

    def __init__(self, devices: "Sequence[torch.device | str]") -> None:
        devs = tuple(_indexed(torch.device(d)) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        distinct = sorted({str(d) for d in devs})
        if len(distinct) > 1:
            raise ValueError(
                f"the mesh's shards sit on {len(distinct)} devices "
                f"({', '.join(distinct)}); a mesh over several cards is not "
                "supported yet (ROADMAP.md, Queue A, A 16): every shard must "
                "sit on one device")
        self.devices = devs

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device that holds every shard's state."""
        return self.devices[0]


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:i``, so that one card is one
    device however it is named."""
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return d


def create_mesh(n_devices: int | None = None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all by default),
    as JAX's ``create_mesh`` over ``jax.devices()``; raises when fewer are
    present (or none). Several distinct cards raise too (:class:`Mesh`)."""
    present = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = present if n_devices is None else int(n_devices)
    if n > present or n < 1:
        raise ValueError(f"requested {n} devices, only {present} present")
    return Mesh([torch.device("cuda", i) for i in range(n)])
