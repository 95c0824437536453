"""The bulk lane's route, on the CPU: the port's store against the JAX store.

The port's ``DeviceBucketStore`` decides a bulk chunk of one batch (K = 1:
at most ``max_batch`` rows) with the table's flush (``acquire_packed``,
``window_packed``), its operand padded to its rows (a power of two >= 8)
and the host's same-slot prefix in row 3; a chunk of more batches, or one
whose same-slot prefix passes 2^31 (the flush's int32 row 3 would saturate
it to another float32), takes the scan (``acquire_scan``, ``window_scan``).
The JAX store scans every chunk, padded to ``max_batch``: its K = 1 scan
decides with ``acquire_core`` (``window_acquire_core``), the rule of its
flush.

One parametrised test drives both stores (``max_batch`` 64, the same
seeded keys, counts and ``ManualClock`` schedule) through two bulk calls
and a later read (``peek_blocking`` for buckets; a bulk of zero-count
probes for windows, which consumes nothing) over bucket and sliding-window
tables, bulks of 1, 3, 8, 11, 64 and 65 rows, u8 counts, i32 counts above
255 and counts with zero-count probes, with and without ``remaining``; and
one slot asked for 2^30 three times (a prefix of 2^31, saturated in the
operand to 2^31 - 1, which rounds to the same float32) and four times (the
scan). Keys repeat in fewer than a quarter of the rows, so that neither
store coalesces them into groups (the three- and four-row cases turn
coalescing off). Grants, ``remaining`` and the later read are equal: fill
rates are powers of two and windows 1024 ticks, so that XLA's fused
multiply-adds on the CPU round as the port does. The port's wrapper calls
and ``metrics.rows_processed`` show the route.
"""

import asyncio

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    DeviceBucketStore as JStore,
)
from distributedratelimiting.redis_tpu_torch import (
    DeviceBucketStore,
    ManualClock,
)
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

MAX_BATCH = 64
START = 10_000  # the second call crosses a window boundary (10,240)
RATE = 64.0  # tokens a second: 1/16 a tick
WINDOW_S = 1.0  # 1024 ticks
ROWS = (1, 3, 8, 11, 64, 65)
COUNTS = ("u8", "i32", "probes")
#: A kind's (capacity or limit) for each count form.
LIMITS = {"u8": 40.0, "i32": 5000.0, "probes": 12.0}
WRAPPERS = {"bucket": ("acquire_packed", "acquire_scan_packed"),
            "window": ("window_packed", "window_scan_packed")}

CASES = [(kind, rows, counts, rem) for kind in ("bucket", "window")
         for rows in ROWS for counts in COUNTS for rem in (True, False)]
# One slot asked for 2^30 three times (the flush) and four times (the scan).
CASES += [(kind, rows, "2^30", True) for kind in ("bucket", "window")
          for rows in (3, 4)]


def _inputs(kind, rows, counts, rem):
    """Seeded keys and two rounds of counts."""
    rng = np.random.default_rng(
        [sum(map(ord, kind)), rows, sum(map(ord, counts)), int(rem)])
    if counts == "2^30":
        return ["hot"] * rows, [[2**30] * rows, [2**30] * rows]
    keys = [f"k{i}" for i in range(rows)]
    for i in rng.choice(rows, rows // 6, replace=False):
        keys[i] = keys[int(rng.integers(0, rows))]  # < 1/4 of rows repeat
    rounds = []
    for _ in range(2):
        if counts == "u8":
            c = rng.integers(1, 41, rows)
        elif counts == "i32":
            c = rng.integers(256, 3001, rows)
        else:
            c = np.where(rng.random(rows) < 0.3, 0, rng.integers(1, 21, rows))
        rounds.append(c.tolist())
    return keys, rounds


async def _drive(store, clock, kind, keys, rounds, limit, rem):
    """Two bulk calls 300 ticks apart, then a later read 500 ticks on."""
    out = []
    for c in rounds:
        if kind == "bucket":
            res = await store.acquire_many(keys, c, limit, RATE,
                                           with_remaining=rem)
        else:
            res = await store.window_acquire_many(keys, c, limit, WINDOW_S,
                                                  with_remaining=rem)
        out.append((res.granted.tolist(),
                    None if res.remaining is None
                    else res.remaining.tolist()))
        clock.advance_ticks(300)
    clock.advance_ticks(200)
    if kind == "bucket":
        out.append([store.peek_blocking(k, limit, RATE) for k in keys])
    else:
        probe = await store.window_acquire_many(keys, [0] * len(keys), limit,
                                                WINDOW_S)
        out.append((probe.granted.tolist(), probe.remaining.tolist()))
    return out


@pytest.mark.parametrize("kind,rows,counts,rem", CASES)
def test_bulk_route_matches_jax(monkeypatch, kind, rows, counts, rem):
    keys, rounds = _inputs(kind, rows, counts, rem)
    limit = float(2**32) if counts == "2^30" else LIMITS[counts]
    calls = []
    for name in WRAPPERS[kind]:
        fn = getattr(ck, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(ck, name, spy)
    coalesce = counts != "2^30"
    # Past 2^24 a sliding estimate across a window boundary would round
    # apart (XLA fuses it on the CPU): the 2^30 cases stay in one window.
    start = START if coalesce else 10_240
    port = DeviceBucketStore(device="cpu", clock=ManualClock(start),
                             n_slots=256, max_batch=MAX_BATCH,
                             coalesce_duplicates=coalesce)
    jax_ = JStore(clock=JClock(start), n_slots=256, max_batch=MAX_BATCH,
                  coalesce_duplicates=coalesce)
    got = asyncio.run(_drive(port, port.clock, kind, keys, rounds, limit,
                             rem))
    want = asyncio.run(_drive(jax_, jax_.clock, kind, keys, rounds, limit,
                              rem))
    assert got == want
    granted = got[0][0] + got[1][0]
    if counts == "2^30":
        assert got[0][0] == [True] * rows  # fits 2^32 exactly
    elif rows >= 8:
        assert 0 < sum(granted) < len(granted)  # both outcomes

    flush, scan = WRAPPERS[kind]
    flushes = calls.count(flush)
    scans = calls.count(scan)
    launches = port.metrics.launches
    bulks = 2 if kind == "bucket" else 3  # the window's probe is a bulk
    pad = max(8, 1 << (rows - 1).bit_length())
    assert launches == flushes + scans == bulks
    if rows > MAX_BATCH:  # one K = 2 scan of 2 x 64 rows a call
        assert scans == bulks
        assert port.metrics.rows_processed == 2 * MAX_BATCH * bulks
    elif counts == "2^30" and rows == 4:
        # Four asks of 2^30 on one slot: a prefix past 2^31, scanned at 64
        # rows; the window's zero-count probe has none, and is a flush.
        assert scans == 2
        assert port.metrics.rows_processed == 2 * MAX_BATCH + pad * (bulks - 2)
    else:  # every bulk call is one flush of its rows
        assert flushes == bulks
        assert port.metrics.rows_processed == pad * bulks
