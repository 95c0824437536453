"""Live limit mutation — versioned bucket and window config rewrites with
no restart and no dropped balances, on the port.

The JAX package's ``runtime/liveconfig.py`` with its names and ``__all__``.
A config change is an epoch-versioned control operation:

- A **rule** maps one retired config to its replacement: ``(kind, old_a,
  old_b) → (new_a, new_b)``, where ``kind`` is ``bucket`` / ``window`` /
  ``fwindow`` and ``(a, b)`` are the wire's config operands (capacity and
  rate, or limit and window seconds). Rules commit at a **config version**
  that only moves forward, so ``OP_CONFIG`` is idempotent at its version
  and safe to retry after a send.
- Commit is **two-phase per node**: ``prepare`` stages the rule (validated,
  no change in serving; a failure aborts the mutation at the old version),
  ``commit`` flips the serving gate and *rebases* the state.
- The **rebase** carries each key of the retired config into the new
  config's table through the saturating ``debit_many`` (``debit_packed`` on
  the card): a fresh key under the new config is born full and is debited
  by what it had spent, ``max(0, old_cap − tokens)``, so a consumed budget
  stays consumed. Windows replay their current-window count through the
  window flushes. Saturating by construction, the rebase can only
  under-admit.
- **Stale clients chase one routable error**: a request carrying a retired
  config answers ``config moved: {json}`` (the store untouched, so the
  re-send is not a replay); the client learns the rule, re-sends once with
  the new operands and translates every later call up front.

The gate flips before the old table is exported, so traffic after the flip
lands on the new table; requests already past the gate when it flips are
bounded by the serving pipeline's in-flight depth. As in JAX, the snapshot
runs off the loop (under the store lock), then the extraction and the
bucket debit run on the loop with no await between them that yields (the
debit launches before its readback), so only a request the snapshot's
lock held up can reach the new table before the carry does.

One difference from the JAX module, which leaves the state after a commit
the same: the window rows of the retired config replay concurrently (one
``asyncio.gather``), where JAX awaits one acquire a key. A snapshot holds
each key once, so the rows are independent, and the card store decides
them in flushes of up to ``max_batch`` rows instead of one launch a key.
"""

from __future__ import annotations

import asyncio
import json
import math
from typing import Mapping

from distributedratelimiting.redis_tpu_torch.runtime import wire

__all__ = ["ConfigState", "ConfigRule", "StaleConfigError",
           "ConfigError", "CONFIG_MOVED_PREFIX", "KINDS",
           "OP_KINDS", "BULK_KINDS"]

#: Stable prefix of the routable "retired config" error: clients detect it
#: with a substring match and re-send with the rule's new operands. The
#: JSON payload after the prefix is the rule itself.
CONFIG_MOVED_PREFIX = "config moved"

#: Config families a rule may rewrite. Semaphore limits are excluded: a
#: semaphore's limit is per-call state, not table identity.
KINDS = ("bucket", "window", "fwindow")

#: The config kind each gated wire op's ``(a, b)`` belongs to: the one
#: table every lane routes through (server dispatch, native batch lane,
#: client translation). PEEK gates too: a probe of a retired table would
#: report a number nobody serves from.
OP_KINDS = {wire.OP_ACQUIRE: "bucket", wire.OP_WINDOW: "window",
            wire.OP_FWINDOW: "fwindow", wire.OP_PEEK: "bucket"}

#: Bulk-frame kind → config kind (the frame-level gate: one ``(kind, a,
#: b)`` decides a whole ACQUIRE_MANY frame).
BULK_KINDS = {wire.BULK_KIND_BUCKET: "bucket",
              wire.BULK_KIND_WINDOW: "window",
              wire.BULK_KIND_FWINDOW: "fwindow"}


class ConfigError(RuntimeError):
    """Config control-plane failure (validation, rebase): the mutation
    aborted at the old version."""


class StaleConfigError(ConfigError):
    """The announced version is not past the node's committed one
    (prepare), or conflicts with a rule already staged at that version.
    Re-announcing the current state is idempotent; going backwards is a
    protocol error."""


class ConfigRule:
    """One committed (or staged) config rewrite."""

    __slots__ = ("kind", "old", "new")

    def __init__(self, kind: str, old: "tuple[float, float]",
                 new: "tuple[float, float]") -> None:
        if kind not in KINDS:
            raise ConfigError(f"unknown config kind {kind!r}")
        self.kind = kind
        self.old = (float(old[0]), float(old[1]))
        self.new = (float(new[0]), float(new[1]))
        if self.old == self.new:
            raise ConfigError("config rule rewrites a config to itself")
        for a, b in (self.old, self.new):
            if not (math.isfinite(a) and math.isfinite(b)) or a <= 0:
                raise ConfigError(
                    f"config operands must be finite with a > 0: ({a}, {b})")

    def to_dict(self) -> dict:
        return {"kind": self.kind, "old": list(self.old),
                "new": list(self.new)}

    @classmethod
    def from_dict(cls, data: Mapping) -> "ConfigRule":
        return cls(data["kind"], tuple(data["old"]), tuple(data["new"]))

    def __eq__(self, other) -> bool:
        return (isinstance(other, ConfigRule) and self.kind == other.kind
                and self.old == other.old and self.new == other.new)

    def __repr__(self) -> str:
        return f"ConfigRule({self.kind}, {self.old} -> {self.new})"


def moved_message(kind: str, old: "tuple[float, float]",
                  new: "tuple[float, float]", version: int) -> str:
    """The routable retired-config error text: the stable prefix and the
    rule as JSON, byte for byte the JAX package's (its clients parse it)."""
    return CONFIG_MOVED_PREFIX + ": " + json.dumps(
        {"kind": kind, "old": list(old), "new": list(new),
         "version": int(version)})


def parse_moved(message: str) -> "tuple[str, tuple, tuple, int] | None":
    """Inverse of :func:`moved_message`; ``None`` when the message is not a
    config-moved error or its payload is unreadable (a client then fails
    the call rather than guess operands)."""
    i = message.find(CONFIG_MOVED_PREFIX)
    if i < 0:
        return None
    try:
        data = json.loads(message[i + len(CONFIG_MOVED_PREFIX) + 1:])
        old = (float(data["old"][0]), float(data["old"][1]))
        new = (float(data["new"][0]), float(data["new"][1]))
        return str(data["kind"]), old, new, int(data["version"])
    except (ValueError, KeyError, IndexError, TypeError):
        return None


class ConfigState:
    """A serving node's live-config half: the committed forwarding rules
    and the staged (prepared, uncommitted) mutations. Dormant until the
    first rule commits (``active`` is one attribute read on the hot
    path)."""

    #: Committed rules kept in the forwarding map; the oldest go first.
    _MAX_RULES = 1 << 10

    def __init__(self) -> None:
        self.version = 0
        #: ``(kind, old_a, old_b) → (new_a, new_b, version)``: the serving
        #: gate's lookup. Chains compress on commit (A→B then B→C makes
        #: A→C), so a client two mutations behind chases one error.
        self.rules: dict[tuple, tuple[float, float, int]] = {}
        self._staged: "dict[int, ConfigRule]" = {}
        # Serializes prepare/commit/abort: a commit's rebase spans awaits,
        # and a retried commit must meet the idempotent no-op, not run a
        # second rebase.
        self._lock = asyncio.Lock()
        # OP_STATS "config" section and the config_* families.
        self.moved_errors = 0
        self.commits = 0
        self.aborts = 0
        self.adopts = 0
        self.stale_announces = 0
        self.rebased_rows = 0

    @property
    def active(self) -> bool:
        return bool(self.rules)

    # -- serving gate --------------------------------------------------------
    def forward(self, kind: str, a: float, b: float
                ) -> "tuple[float, float, int] | None":
        """``None`` (the config is current) or the committed ``(new_a,
        new_b, version)`` the caller must be redirected to."""
        return self.rules.get((kind, float(a), float(b)))

    def moved(self, kind: str, a: float, b: float,
              fwd: "tuple[float, float, int]") -> str:
        self.moved_errors += 1
        return moved_message(kind, (a, b), (fwd[0], fwd[1]), fwd[2])

    # -- control plane -------------------------------------------------------
    def snapshot_payload(self) -> dict:
        """The OP_CONFIG fetch reply: the committed version and rules
        (staged mutations are invisible until they commit)."""
        return {"version": self.version,
                "rules": [{"kind": k[0], "old": [k[1], k[2]],
                           "new": [na, nb], "version": v}
                          for k, (na, nb, v) in sorted(self.rules.items())]}

    async def announce(self, payload: Mapping, store) -> int:
        """One OP_CONFIG control frame: ``{"prepare": rule, "version": v}``
        stages, ``{"commit": v}`` flips the gate and rebases through
        ``store``, ``{"abort": v}`` drops the staged rule, and ``{"adopt":
        snapshot}`` installs another node's committed rule set without a
        rebase (the restart lane: the state already arrived rebased). Each
        form is idempotent at its version; a stale version raises the
        typed, routable error. Returns the committed version."""
        async with self._lock:
            if "prepare" in payload:
                return self._prepare(int(payload["version"]),
                                     ConfigRule.from_dict(
                                         payload["prepare"]))
            if "commit" in payload:
                return await self._commit(int(payload["commit"]), store)
            if "abort" in payload:
                self._staged.pop(int(payload["abort"]), None)
                self.aborts += 1
                return self.version
            if "adopt" in payload:
                return self._adopt(payload["adopt"])
            if not payload:
                return self.version
            raise ConfigError(
                f"unknown OP_CONFIG form {sorted(payload)!r}")

    def _adopt(self, data: Mapping) -> int:
        version = int(data.get("version", 0))
        if version <= self.version:
            return self.version  # a stale or duplicate adopt: no-op
        rules: dict[tuple, tuple[float, float, int]] = {}
        for row in data.get("rules", ()):
            rule = ConfigRule.from_dict(row)  # validated, typed errors
            rules[(rule.kind, rule.old[0], rule.old[1])] = (
                rule.new[0], rule.new[1], int(row.get("version", version)))
        self.rules = rules
        self.version = version
        self.adopts += 1
        return self.version

    def _prepare(self, version: int, rule: ConfigRule) -> int:
        if version <= self.version:
            self.stale_announces += 1
            raise StaleConfigError(
                f"stale config version {version} "
                f"(this node committed {self.version})")
        staged = self._staged.get(version)
        if staged is not None and staged != rule:
            # Two coordinators raced one target version with different
            # rules: the second loses loudly.
            self.stale_announces += 1
            raise StaleConfigError(
                f"conflicting config rule already staged at version "
                f"{version}; rebase and retry")
        self._staged[version] = rule
        return self.version

    async def _commit(self, version: int, store) -> int:
        if version <= self.version:
            return self.version  # a retried commit no-ops
        rule = self._staged.pop(version, None)
        if rule is None:
            raise ConfigError(
                f"commit for unstaged config version {version}; "
                "prepare it first (or the abort already dropped it)")
        # Gate first: from here every new request carrying the old config
        # answers the routable moved error, so the old table quiesces (up
        # to the in-flight depth) before it is exported.
        old_key = (rule.kind, rule.old[0], rule.old[1])
        self.rules[old_key] = (rule.new[0], rule.new[1], version)
        # Chain compression: A→old becomes A→new; a revert (new == A)
        # deletes A's rule, since A→A would bounce every A frame to itself.
        for k, (na, nb, _v) in list(self.rules.items()):
            if k != old_key and (k[0], na, nb) == old_key:
                if (k[1], k[2]) == rule.new:
                    del self.rules[k]
                else:
                    self.rules[k] = (rule.new[0], rule.new[1], version)
        while len(self.rules) > self._MAX_RULES:
            self.rules.pop(next(iter(self.rules)))
        self.version = version
        try:
            self.rebased_rows += await _rebase_state(store, rule)
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            # The gate flipped and the version advanced: the new config
            # serves (init-on-miss full). A failed carry is logged and
            # visible; unwinding the version would split the fleet's gates.
            from distributedratelimiting.redis_tpu_torch.utils import log

            log.error_evaluating_kernel(exc)
        self.commits += 1
        return self.version

    def stats(self) -> dict:
        return {"version": self.version, "rules": len(self.rules),
                "staged": len(self._staged),
                "moved_errors": self.moved_errors,
                "commits": self.commits, "aborts": self.aborts,
                "adopts": self.adopts,
                "stale_announces": self.stale_announces,
                "rebased_rows": self.rebased_rows}


async def _rebase_state(store, rule: ConfigRule) -> int:
    """Carry the retired config's consumed budget into the new config's
    table through the store's public state lanes. Buckets: a fresh key
    under the new config is born full, so debiting ``max(0, old_cap −
    tokens)`` (clamped by the saturating kernel) lands ``new_cap − spent``.
    Windows: the current window's count replays, floored and clamped to the
    new limit. A store that cannot enumerate its keys (fingerprint
    directories, the mesh) raises :class:`ConfigError`. Returns the rows of
    the retired config."""
    from distributedratelimiting.redis_tpu_torch.runtime import placement

    try:
        snap = await asyncio.to_thread(store.snapshot)
        entries = placement.extract_entries(snap, lambda _k: True)
    except asyncio.CancelledError:
        raise
    except Exception as exc:
        raise ConfigError(
            f"store cannot enumerate keys for a config rebase "
            f"({exc!r}); the mutation must abort — committing blind "
            "would reset every bucket to a full budget") from exc
    n = 0
    if rule.kind == "bucket":
        keys, amounts = [], []
        for key, cap, rate, tokens, _age in entries.get("buckets", ()):
            if (float(cap), float(rate)) != rule.old:
                continue
            spent = max(0.0, float(cap) - float(tokens))
            if spent > 0.0:
                keys.append(key)
                amounts.append(spent)
            n += 1
        if keys:
            await placement._debit_buckets(
                store, {rule.new: (keys, amounts)})
        return n
    from distributedratelimiting.redis_tpu_torch.ops import bucket_math

    interp_want = rule.kind == "window"
    new_limit, new_window = rule.new
    acquire = (store.window_acquire if interp_want
               else store.fixed_window_acquire)
    old_wt = int(rule.old[1] * bucket_math.TICKS_PER_SECOND)
    replays = []
    for key, limit, wt, interp, _prev, curr, behind in \
            entries.get("windows", ()):
        if (float(limit), int(wt)) != (rule.old[0], old_wt) \
                or bool(interp) != interp_want or behind != 0:
            continue
        # Floor, not ceil: a fractional carry rounded up past a fractional
        # limit would be denied, record nothing and reset the key to a
        # full budget. Flooring under-carries by < 1.
        count = int(math.floor(min(float(curr), new_limit)))
        if count > 0:
            replays.append(acquire(key, count, new_limit, new_window))
        n += 1
    await asyncio.gather(*replays)
    return n
