#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Print the card's name and power limit; build the CUDA kernels from
   ``distributedratelimiting/redis_tpu_torch/csrc`` (one ``nvcc`` per source,
   in parallel) and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, on seeded
   inputs at the main path's shapes: ``sweep_expired`` over 2^24 slots (and
   the TTL-saturation case), ``acquire_packed`` and ``acquire_grouped`` at
   B = 4096 with Zipf-like duplicates, and the bulk lane's
   ``acquire_scan_packed`` on one chunk of K = 32 batches of 4096 (Zipf(1.2)
   slots duplicated within and across batches, 2% padding, three ticks)
   with the fused u8 operand (bits out and f32 out) and the i32 operand
   (counts up to 1000), and on a chunk of distinct slots within each batch
   (the main path's bulk); the counter kernels ``sync_counters`` at B = 2^20
   (Zipf(1.1) slots with duplicates, 2% padding, half the counters live,
   ticks on both sides of the stored ones; distinct slots) and B = 8, and
   ``sweep_counters`` over 2^20 counters. Grants, bits, masks, ``exists``,
   ``last_ts``, counter replies and periods must be equal; remaining and
   tokens within atol 1e-4, counter values equal for distinct slots and,
   where a slot takes r > 1 adds, within r spacings of its float32 value
   (atomic adds in no fixed order). Time each
   (median of CUDA-event timings, and device time from ``torch.profiler``)
   beside the plain version and the bound.
3. The main path at full size: ``PartitionedRateLimiter`` over
   ``DeviceBucketStore(device="cuda", n_slots=2**24)`` — ``acquire_many``
   over 10,000,000 distinct keys, one more bulk chunk under
   ``torch.profiler`` (its device busy share and kernel launches),
   concurrent ``acquire_async`` on hot and cold keys checked against a host
   oracle (cap-5 bucket × 32 asks → 5), then ``sweep_all`` past the TTL
   with an exact eviction count. Every table resolves keys through the
   native key directory (checked). Each phase prints its rate and where its
   host time went (the store's dispatch spans, the key directory, Python's
   garbage collector).
4. The approximate path, 1M keys, Zipf(1.1) (BASELINE.json config 3), on a
   second store with ``counter_slots=2**20``: one ``sync_counters_many``
   over 1,000,000 distinct keys (one launch; every score equals its count),
   16 rounds of 2^18 Zipf(1.1) draws pre-aggregated per key and one round
   left unaggregated, each reply checked against a host float32 oracle of
   the decay; eight ``ApproximateTokenBucketRateLimiter``s sharing one
   counter at a staggered cadence (the instance estimate reaches 8, grants
   per period stay within the limit plus the staleness bound); then
   ``sweep_all`` a day later evicts exactly the live counters. Prints the
   fleet sync's counters/s and its host split.
5. The shared store server (README "Multi-host", BASELINE config 2's
   shape): ``BucketStoreServer`` over a third ``DeviceBucketStore`` (2^24
   slots, 2^20 counters, a ManualClock) on 127.0.0.1, limiters on
   ``RemoteBucketStore`` clients. ``acquire_many`` over 10,000,000 distinct
   keys as ``ACQUIRE_MANY`` frames resolved from the frames' bytes on the
   server (``wire.KeyBlob``), then 1M of them with remaining; from a client
   process of its own (``chip_smoke.py --scalar-client``), 20 rounds of
   ``acquire_async`` over 10,000 uniform keys with 64 tasks, alternating a
   coalescing client and one sending a frame per request (token limit 10:
   every round grants all, then denies all; each key grants exactly 10);
   cap-5 × 32 → 5 on both lanes; eight approximate limiters syncing
   one counter over the wire; the periodic sweeper (0.5 s) evicting exactly
   every bucket and the counter a day later. Prints the wire rates,
   latencies (client and server), frames, and the server's key-blob
   resolve beside the in-process string resolve.
6. The console entry point on the card: ``python -m
   distributedratelimiting.redis_tpu_torch.runtime.server --port 0 --slots
   1048576 --sweep-period 1`` as a subprocess: its listening line, ping,
   cap-5 × 32 → 5, ``OP_STATS`` keys, SIGTERM → exit 0.
7. Print ``{"kernels": [...]}``: per kernel its launches on each path of
   phases 3–5 (``launches_by_path``; counts set to 0 before each path and
   read after it; > 0 on the path the kernel serves, and every kernel > 0
   on the server path) and their sum (``launches``), the error against the
   plain version, and its times; before it, each phase's wall seconds.
8. Last line: ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the rest of the repository beside it.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 1234
N_SLOTS = 2**24
BATCH = 4096
N_KEYS = 10_000_000
SCAN_K = 32  # batches in one bulk chunk (the store's largest K)
COUNTER_SLOTS = 2**20
N_COUNTER_KEYS = 1_000_000
COUNTER_ROUNDS = 16
ROUND_DRAWS = 2**18
ZIPF_S = 1.1
DECAY_PER_S = 10.0  # the counters' decay rate (per second)
ATOL = 1e-4
#: H100 SXM device-memory rate and float32 rate outside the tensor cores
#: (NVIDIA data sheet, at the 700 W limit), for the bound.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPS = 30
#: The server path's scalar phase (BASELINE config 2's shape).
N_SCALAR_KEYS = 10_000
SCALAR_LIMIT = 10
SCALAR_ASKS = 20
SCALAR_TASKS = 64
SCALAR_LANES = ("coalesced", "per-request")


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _median_ms(fn, setup=None, reps=REPS, warmup=3, inner=1) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call."""
    import torch

    times = []
    for i in range(warmup + reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _device_ms(fn, kernel_names, reps=20):
    """Device time per call of the named CUDA kernels, summed from a
    ``torch.profiler`` trace of ``reps`` calls; ``None`` if the trace holds
    no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if any(k in e.key for k in kernel_names))
    return us / 1e3 / reps if us > 0 else None


def _time_calls(obj, name: str, acc: list) -> None:
    """Wrap the method ``obj.name`` so that its wall time accrues to
    ``acc[0]``."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[0] += time.perf_counter() - t

    setattr(obj, name, timed)


class _GcClock:
    """Wall time spent in Python's cyclic garbage collector (a
    ``gc.callbacks`` entry)."""

    def __init__(self) -> None:
        self.total = 0.0
        self._start = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.total += time.perf_counter() - self._start


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 (non-tensor-core) rate."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item()) if a.numel() \
        else 0.0


def _check_equal(what, got, want) -> None:
    import torch

    if not torch.equal(got.cpu(), want.cpu()):
        bad = int((got.cpu() != want.cpu()).sum())
        raise AssertionError(f"{what}: {bad} elements differ")


def _check_close(what, got, want) -> float:
    err = _max_err(got, want)
    if not err <= ATOL:
        raise AssertionError(f"{what}: max abs error {err} > {ATOL}")
    return err


def _check_repeated_adds(what, slots, got, want) -> tuple[float, float]:
    """Counter values after a sync whose slots repeat, each slot against its
    own limit. A sync sets every touched slot to its decayed value, then
    slot s takes r_s adds in an order the atomics choose. Decayed values and
    counts are >= 0 here, so every partial sum lies within the final one and
    each add rounds by at most half a spacing of max(|got_s|, |want_s|): two
    orders differ by at most r_s such spacings. A slot with one add or none
    must be equal. ``slots`` indexes ``got`` and ``want`` (out-of-range rows
    dropped). Returns the largest error and the limit of that slot."""
    n = len(got)
    slots = slots[(slots >= 0) & (slots < n)]
    reps = np.bincount(slots, minlength=n)
    got64, want64 = got.astype(np.float64), want.astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
    tol = np.where(reps > 1, reps, 0) * np.spacing(mag).astype(np.float64)
    err = np.abs(got64 - want64)
    bad = np.flatnonzero(err > tol)
    if len(bad):
        s = bad[np.argmax(err[bad] - tol[bad])]
        raise AssertionError(
            f"{what}: {len(bad)} slots past their limit, e.g. slot {s} "
            f"({reps[s]} adds): {got[s]} vs {want[s]}, limit {tol[s]}")
    worst = int(np.argmax(err))
    return float(err[worst]), float(tol[worst])


def kernel_phase(torch, K, ck, dev):
    """Each kernel against its plain version on the card; returns per-kernel
    results (error, times, bound)."""
    rng = np.random.default_rng(SEED)
    cap, rate = 100.0, 10 / 1024
    res = {}

    # -- sweep_expired at N = 2^24 -------------------------------------------
    n = N_SLOTS
    now = 2_000_000
    tokens = torch.tensor(rng.uniform(0, cap, n).astype(np.float32), device=dev)
    last_ts = torch.tensor(rng.integers(now - 30_000, now, n).astype(np.int32),
                           device=dev)
    exists0 = torch.tensor(rng.random(n) < 0.5, device=dev)
    state = K.BucketState(tokens, last_ts, exists0.clone())
    mask, counts = ck.sweep_expired(state, now, cap, rate)
    plain = K.BucketState(tokens, last_ts, exists0.clone())
    _, expired = K.sweep_expired(plain, now, cap, rate)
    torch.cuda.synchronize()
    _check_equal("sweep mask", mask.bool(), expired)
    _check_equal("sweep exists", state.exists, plain.exists)
    want_tiles = torch.nn.functional.pad(
        expired.int(), (0, counts.numel() * ck.TILE - n)).view(-1, ck.TILE
                                                               ).sum(1)
    _check_equal("sweep tile counts", counts, want_tiles.int())
    n_expired = int(counts.sum())
    if not 0 < n_expired < int(exists0.sum()):
        raise AssertionError(f"sweep case expired {n_expired}: not a mix")
    ms = _median_ms(lambda: ck.sweep_expired(state, now, cap, rate),
                    setup=lambda: state.exists.copy_(exists0))
    plain_ms = _median_ms(lambda: K.sweep_expired(plain, now, cap, rate),
                          setup=lambda: plain.exists.copy_(exists0))
    dev_ms = _device_ms(lambda: ck.sweep_expired(state, now, cap, rate),
                        ["sweep_kernel"])
    t = counts.numel()
    # ~12 operations a slot: the TTL (sub, max, max, div, ceil, max, min,
    # select), the elapsed time (sub, max) and the test (compare, and).
    res["sweep_expired"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        bytes=9 * n + 2 * n + 4 * t, ops=12 * n, device_ms=dev_ms)
    print(f"sweep_expired N={n}: expired {n_expired}, equal to plain; "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms, device time {dev_ms} ms)")

    # TTL saturation: with rate 0 or 1e-9 the float32 TTL clamp is 2^31 and
    # must convert to 2^31 - 1, so nothing idle for 2^30 ticks expires.
    m = min(2**20, n)
    # Deficits of 10+ tokens: at rate 1e-9 the TTL passes 2^31 ticks.
    sat = K.BucketState(tokens[:m] * 0.9, torch.zeros(m, dtype=torch.int32,
                                                        device=dev),
                        torch.ones(m, dtype=torch.bool, device=dev))
    for r in (0.0, 1e-9):
        sat_mask, sat_counts = ck.sweep_expired(sat, 2**30, cap, r)
        ref = K.BucketState(sat.tokens, sat.last_ts,
                            torch.ones(m, dtype=torch.bool, device=dev))
        _, ref_expired = K.sweep_expired(ref, 2**30, cap, r)
        _check_equal(f"saturation mask rate={r}", sat_mask.bool(),
                     ref_expired)
        if int(sat_counts.sum()) != 0 or not bool(sat.exists.all()):
            raise AssertionError(f"TTL saturation: slots expired at {r}")
    print("sweep_expired TTL saturation (rate 0, 1e-9): nothing expired, "
          "equal to plain")

    # -- acquire_packed / acquire_grouped at B = 4096 -------------------------
    from distributedratelimiting.redis_tpu_torch.runtime.store import (
        _duplicate_prefix_host,
    )

    table = (torch.tensor(rng.uniform(0, cap, n).astype(np.float32),
                          device=dev),
             torch.tensor(rng.integers(now - 3000, now, n).astype(np.int32),
                          device=dev),
             torch.tensor(rng.random(n) < 0.7, device=dev))
    slots = (rng.zipf(1.2, BATCH) - 1) % n
    slots[rng.random(BATCH) < 0.02] = -1
    slots = slots.astype(np.int32)
    cnt = rng.integers(0, 40, BATCH).astype(np.int32)
    valid = slots >= 0
    packed = np.zeros((4, BATCH), np.int32)
    packed[0], packed[1], packed[2] = slots, cnt, now
    packed[3][valid] = _duplicate_prefix_host(slots[valid], cnt[valid])
    uniq, sizes = np.unique(slots[valid], return_counts=True)
    g = len(uniq)
    packed5 = np.full((5, BATCH), -1, np.int32)
    packed5[1:] = 0
    packed5[0, :g], packed5[2] = uniq, now
    packed5[1, :g] = rng.integers(1, 4, g)
    packed5[4, :g] = sizes
    d_uniq = g  # distinct valid slots gathered and written back
    # Bytes: the operand read, out written, 9 B gathered and 9 B written
    # back per distinct slot. Operations: ~15 a row (refill, prefix test,
    # remaining, the consumption add); the grouped division and clamps ~18.
    cases = {
        "acquire_packed": (ck.acquire_packed, K.acquire_batch_packed, packed,
                           16 * BATCH + 8 * BATCH + 18 * d_uniq, 15 * BATCH),
        "acquire_grouped": (ck.acquire_grouped,
                            K.acquire_batch_packed_grouped, packed5,
                            20 * BATCH + 8 * BATCH + 18 * d_uniq, 18 * BATCH),
    }
    for name, (kernel, plain_fn, op, nbytes, ops) in cases.items():
        op_d = torch.from_numpy(op).to(dev)
        ks = K.BucketState(*(x.clone() for x in table))
        ps = K.BucketState(*(x.clone() for x in table))
        out = kernel(ks, op_d, cap, rate)
        _, pout = plain_fn(ps, op_d, cap, rate)
        torch.cuda.synchronize()
        _check_equal(f"{name} grants", out[0], pout[0])
        err = max(_check_close(f"{name} remaining", out[1], pout[1]),
                  _check_close(f"{name} tokens", ks.tokens, ps.tokens))
        _check_equal(f"{name} last_ts", ks.last_ts, ps.last_ts)
        _check_equal(f"{name} exists", ks.exists, ps.exists)
        granted = float(out[0].sum())
        if not 0 < granted:
            raise AssertionError(f"{name}: nothing granted")
        ms = _median_ms(lambda: kernel(ks, op_d, cap, rate), inner=20)
        plain_ms = _median_ms(lambda: plain_fn(ps, op_d, cap, rate))
        dev_ms = _device_ms(lambda: kernel(ks, op_d, cap, rate),
                            ["flush_kernel"])
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bytes=nbytes, ops=ops,
                         device_ms=dev_ms)
        print(f"{name} B={BATCH} ({d_uniq} distinct slots): grants equal, "
              f"max abs err {err:.3g}; {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"device time {dev_ms} ms)")
    res["acquire_scan"] = scan_case(torch, K, ck, dev, rng, table, now, cap,
                                    rate)
    del table, tokens, last_ts, exists0, state, plain, sat
    torch.cuda.empty_cache()
    res.update(counter_cases(torch, K, ck, dev, rng))
    return res


def _sync_packed(rng, b, n, now, distinct):
    """A counter-sync operand ``i32[3, B]``: Zipf(1.1) slots (duplicates) or
    distinct ones, 2% padding, float counts bitcast, the tick."""
    if distinct:
        slots = rng.permutation(n)[:b].astype(np.int32)
    else:
        slots = ((rng.zipf(ZIPF_S, b) - 1) % n).astype(np.int32)
    slots[rng.random(b) < 0.02] = -1
    counts = rng.uniform(0, 50, b).astype(np.float32)
    counts[slots < 0] = 0.0
    return np.stack([slots, counts.view(np.int32), np.full(b, now, np.int32)])


def counter_cases(torch, K, ck, dev, rng) -> dict:
    """``sync_counters`` and ``sweep_counters`` against their plain versions
    on a counter table of 2^20 slots: half live, stored ticks on both sides
    of ``now`` (a clock behind some of them)."""
    n, now, rate = COUNTER_SLOTS, 3_000_000, DECAY_PER_S / 1024
    table = (torch.tensor(rng.uniform(0, 1000, n).astype(np.float32),
                          device=dev),
             torch.tensor(rng.uniform(0, 5000, n).astype(np.float32),
                          device=dev),
             torch.tensor(rng.integers(now - 3000, now + 300, n).astype(
                 np.int32), device=dev),
             torch.tensor(rng.random(n) < 0.5, device=dev))
    res = {}
    sync = {}
    for label, b, distinct in (("Zipf(1.1)", n, False),
                               ("distinct", n, True), ("B = 8", 8, False)):
        packed = _sync_packed(rng, b, n, now, distinct)
        valid = packed[0] >= 0
        uniq, reps = np.unique(packed[0][valid], return_counts=True)
        op = torch.from_numpy(packed).to(dev)
        ks = K.CounterState(*(x.clone() for x in table))
        ps = K.CounterState(*(x.clone() for x in table))
        got = ck.sync_counters(ks, op, rate)
        _, want = K.sync_batch_packed(ps, op, rate)
        torch.cuda.synchronize()
        _check_equal(f"sync {label} replies", got, want)
        _check_equal(f"sync {label} period", ks.period, ps.period)
        _check_equal(f"sync {label} last_ts", ks.last_ts, ps.last_ts)
        _check_equal(f"sync {label} exists", ks.exists, ps.exists)
        if (reps > 1).any():
            # Duplicates' adds land in atomic order (the plain version's
            # index_add_ on the card is atomic too).
            err, tol = _check_repeated_adds(
                f"sync {label} value", packed[0], ks.value.cpu().numpy(),
                ps.value.cpu().numpy())
        else:
            _check_equal(f"sync {label} value", ks.value, ps.value)
            err, tol = 0.0, 0.0
        ms = _median_ms(lambda: ck.sync_counters(ks, op, rate),
                        inner=5 if b > 8 else 20)
        plain_ms = _median_ms(lambda: K.sync_batch_packed(ps, op, rate),
                              reps=5, warmup=1)
        dev_ms = _device_ms(lambda: ck.sync_counters(ks, op, rate),
                            ["sync_kernel"])
        # Bytes: the operand and the reply (20 B a row), 13 B of state read
        # and 13 B written per distinct slot. ~12 operations a row.
        sync[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=None, bytes=20 * b + 26 * len(uniq),
                           ops=12 * b, device_ms=dev_ms)
        print(f"sync_counters ({label}) B={b} ({len(uniq)} distinct slots, "
              f"max repeat {reps.max()}): replies, period, last_ts, exists "
              f"equal to plain, value max abs err {err!r} (that slot's limit "
              f"{tol!r}); {ms:.4f} ms (plain {plain_ms:.4f} ms, device time "
              f"{dev_ms} ms)")
    # The fleet sync of the main path sends distinct keys.
    res["sync_counters"] = dict(sync["distinct"], max_abs_err=max(
        r["max_abs_err"] for r in sync.values()))
    exact_sums_case(torch, K, ck, dev, rng, table, now, rate)

    # sweep_counters over the table: last touches up to two days back.
    last = torch.tensor(rng.integers(now - 2 * 86400 * 1024, now + 300,
                                     n).astype(np.int32), device=dev)
    exists0 = table[3]
    ks = K.CounterState(table[0], table[1], last, exists0.clone())
    ps = K.CounterState(table[0], table[1], last, exists0.clone())
    mask, counts = ck.sweep_counters(ks, now)
    _, expired = K.sweep_counters(ps, now)
    torch.cuda.synchronize()
    _check_equal("sweep_counters mask", mask.bool(), expired)
    _check_equal("sweep_counters exists", ks.exists, ps.exists)
    want_tiles = torch.nn.functional.pad(
        expired.int(), (0, counts.numel() * ck.TILE - n)).view(
            -1, ck.TILE).sum(1)
    _check_equal("sweep_counters tile counts", counts, want_tiles.int())
    n_expired = int(counts.sum())
    if not 0 < n_expired < int(exists0.sum()):
        raise AssertionError(f"sweep_counters expired {n_expired}: no mix")
    ms = _median_ms(lambda: ck.sweep_counters(ks, now),
                    setup=lambda: ks.exists.copy_(exists0))
    plain_ms = _median_ms(lambda: K.sweep_counters(ps, now),
                          setup=lambda: ps.exists.copy_(exists0))
    dev_ms = _device_ms(lambda: ck.sweep_counters(ks, now),
                        ["sweep_counters_kernel"])
    # 7 B a slot (last_ts and exists read, exists and mask written) and the
    # tile counts; ~4 operations a slot (sub, max, compare, and).
    res["sweep_counters"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        bytes=7 * n + 4 * counts.numel(), ops=4 * n, device_ms=dev_ms)
    print(f"sweep_counters N={n}: expired {n_expired}, equal to plain; "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms, device time {dev_ms} ms)")
    return res


def exact_sums_case(torch, K, ck, dev, rng, table, now, rate) -> None:
    """``sync_counters`` at B = 2^20 with Zipf(1.1) duplicates on sums that
    float32 holds exactly: whole-number values and counts (1 to 8), stored
    ticks on a 1024-tick grid around ``now`` so the decay subtracts a whole
    number (``rate`` · 1024 is one). Every order of the atomic adds then
    gives the same value, so every slot, the hottest included, must equal
    the plain version: an add lost to a set that landed after it shows."""
    n = table[0].numel()
    if float(np.float32(rate) * 1024) != float(DECAY_PER_S):
        raise AssertionError("the decay per 1024 ticks is not whole")
    grid = (now - 1024 * rng.integers(-1, 4, n)).astype(np.int32)
    itable = (torch.tensor(rng.integers(0, 1000, n).astype(np.float32),
                           device=dev),
              table[1], torch.tensor(grid, device=dev), table[3])
    packed = _sync_packed(rng, n, n, now, distinct=False)
    counts = rng.integers(1, 9, n).astype(np.float32)
    counts[packed[0] < 0] = 0.0
    packed[1] = counts.view(np.int32)
    reps = np.bincount(packed[0][packed[0] >= 0], minlength=n)
    # Largest partial sum: a value below 1000 plus every count of the slot.
    if 1000 + 8 * int(reps.max()) >= 2**24:
        raise AssertionError("a slot's sum passes 2^24: not exact")
    op = torch.from_numpy(packed).to(dev)
    ks = K.CounterState(*(x.clone() for x in itable))
    ps = K.CounterState(*(x.clone() for x in itable))
    got = ck.sync_counters(ks, op, rate)
    _, want = K.sync_batch_packed(ps, op, rate)
    torch.cuda.synchronize()
    _check_equal("sync exact sums replies", got, want)
    for name in ("value", "period", "last_ts", "exists"):
        _check_equal(f"sync exact sums {name}", getattr(ks, name),
                     getattr(ps, name))
    print(f"sync_counters (Zipf(1.1), exact sums) B={n} (max repeat "
          f"{reps.max()}): replies and every slot's value, period, last_ts, "
          f"exists equal to plain")


def scan_case(torch, K, ck, dev, rng, table, now, cap, rate) -> dict:
    """The bulk lane's kernel on one chunk (K = 32 batches of 4096) against
    the plain per-batch loop: Zipf slots with the fused u8 operand (bits
    and f32 out) and the i32 operand, and distinct slots (fused, bits).
    Returns the main path's variant (distinct slots, fused, bits) with the
    largest error of the four."""
    n = table[0].numel()
    k, b = SCAN_K, BATCH
    zipf = ((rng.zipf(1.2, (k, b)) - 1) % n).astype(np.int32)
    # Distinct slots within each batch, as a bulk call over distinct keys
    # gives them: the kernel skips the sort and the scans.
    distinct = np.stack([rng.choice(n, b, replace=False)
                         for _ in range(k)]).astype(np.int32)
    for slots in (zipf, distinct):
        slots[rng.random((k, b)) < 0.02] = -1
    nows = np.repeat(np.array([now, now + 500, now + 1500], np.int32),
                     [11, 11, k - 22])
    c8 = rng.integers(0, 40, (k, b)).astype(np.uint8)
    c32 = rng.integers(0, 1001, (k, b)).astype(np.int32)
    nows_d = torch.from_numpy(nows).to(dev)
    variants = {
        "fused, bits": (zipf, K.pack_compact5(zipf, c8), c8, False),
        "fused, f32": (zipf, K.pack_compact5(zipf, c8), c8, True),
        "i32, f32": (zipf, np.stack([zipf, c32]), c32, True),
        "fused, bits, distinct slots": (
            distinct, K.pack_compact5(distinct, c8), c8, False),
    }
    out_res = {}
    for label, (slots, op, counts, with_rem) in variants.items():
        valid = slots >= 0
        # Distinct valid slots in the chunk: each is read once and written
        # once at least (9 B each way).
        d = len(np.unique(slots[valid]))
        slots_d = torch.from_numpy(slots).to(dev)
        op_d = torch.from_numpy(op).to(dev)
        counts_d = torch.from_numpy(counts.astype(np.int32)).to(dev)
        ks = K.BucketState(*(x.clone() for x in table))
        ps = K.BucketState(*(x.clone() for x in table))
        got = ck.acquire_scan_packed(ks, op_d, nows_d, cap, rate,
                                     with_remaining=with_rem)
        _, pout = K.acquire_scan_packed(ps, slots_d, counts_d, nows_d, cap,
                                        rate)
        torch.cuda.synchronize()
        err = _check_close(f"scan {label} tokens", ks.tokens, ps.tokens)
        _check_equal(f"scan {label} last_ts", ks.last_ts, ps.last_ts)
        _check_equal(f"scan {label} exists", ks.exists, ps.exists)
        if with_rem:
            _check_equal(f"scan {label} grants", got[:, 0], pout[:, 0])
            err = max(err, _check_close(f"scan {label} remaining", got[:, 1],
                                        pout[:, 1]))
        else:
            _check_equal(f"scan {label} bits", got,
                         K.pack_grant_bits(pout[:, 0] > 0.5))
        granted = int((pout[:, 0] > 0.5).sum())
        if not 0 < granted < int(valid.sum()):  # a mix
            raise AssertionError(f"scan {label}: granted {granted}")
        call = (lambda ks=ks, op_d=op_d, with_rem=with_rem:
                ck.acquire_scan_packed(ks, op_d, nows_d, cap, rate,
                                       with_remaining=with_rem))
        ms = _median_ms(call, inner=5)
        plain_ms = _median_ms(lambda ps=ps, slots_d=slots_d,
                              counts_d=counts_d:
                              K.acquire_scan_packed(ps, slots_d, counts_d,
                                                    nows_d, cap, rate),
                              reps=5, warmup=1)
        dev_ms = _device_ms(call, ["scan_kernel"])
        out_bytes = k * b // 8 if not with_rem else k * 2 * b * 4
        out_res[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
            bytes=op.nbytes + 4 * k + out_bytes + 18 * d, ops=15 * k * b,
            device_ms=dev_ms)
        print(f"acquire_scan ({label}) K={k} B={b} ({d} distinct slots, "
              f"{granted} granted): equal to plain, max abs err {err:.3g}; "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, device time {dev_ms} "
              f"ms)")
    # Every row padding but two rows of one slot a batch: the sort, the scans
    # and the barriers run, and next to no row gathers or writes. The
    # difference to the Zipf chunk is what the gathers and writes cost.
    pad = np.full((k, b), -1, np.int32)
    pad[:, :2] = 7
    pad = torch.from_numpy(K.pack_compact5(pad, c8)).to(dev)
    ps = K.BucketState(*(x.clone() for x in table))
    pad_ms = _median_ms(lambda: ck.acquire_scan_packed(
        ps, pad, nows_d, cap, rate, with_remaining=False), inner=5)
    print(f"acquire_scan (fused, bits) with every row padding but one "
          f"repeated slot a batch: {pad_ms:.4f} ms (sort, scans and "
          f"barriers; next to no gather or write)")
    # The main path's bulk sends distinct keys.
    main = dict(out_res["fused, bits, distinct slots"])
    main["max_abs_err"] = max(r["max_abs_err"] for r in out_res.values())
    return main


async def trace_chunk(torch, ck, lim, keys, card: str) -> None:
    """One bulk chunk of new keys (one K = 32 launch) under
    ``torch.profiler``: the device's busy share of the call's wall time (the
    union of kernel and copy intervals) and the kernels it launched. The
    Chrome trace goes to the build directory."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = await lim.acquire_many(keys, permits=1, with_remaining=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if res.granted_count != len(keys):
        raise AssertionError("traced chunk: not every fresh key granted")
    path = ck.BUILD_DIR / "bulk_chunk_trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if b > end:  # the union of the device intervals
            busy_us += b - max(a, end)
            end = b
    # The function's name, without its namespace, template and arguments.
    kernels = [re.sub(r"^.*?(\w+)(<.*?>)?\(.*$", r"\1", e["name"])
               for e in device if e["cat"] == "kernel"]
    if not kernels:
        raise AssertionError("traced chunk: no kernel in the trace")
    print(f"bulk chunk under torch.profiler: {len(keys)} keys in "
          f"{wall_us / 1e3:.3f} ms ({card}); device busy "
          f"{busy_us / 1e3:.4f} ms = {busy_us / wall_us:.4%} of wall; "
          f"{len(kernels)} kernel launch(es) {kernels}, "
          f"{len(device) - len(kernels)} copies or sets")


def _check_native(store) -> None:
    """Every table's key directory and the counter directory must be the
    native one: no silent fallback to the Python directory on the card."""
    from distributedratelimiting.redis_tpu_torch.runtime.directory import (
        NativeKeyDirectory,
    )

    dirs = [t.dir for t in store._tables.values()] + [store._counter_dir]
    kinds = {type(d).__name__ for d in dirs}
    if kinds != {"NativeKeyDirectory"} or not all(
            isinstance(d, NativeKeyDirectory) for d in dirs):
        raise AssertionError(f"key directories are {kinds}, not native")


async def main_path(torch, ck, pkg, card: str) -> dict:
    """The port's serving path at full size; returns the kernel launches it
    made."""
    from distributedratelimiting.redis_tpu_torch.utils.tracing import (
        ProfilingSession,
    )

    clock = pkg.ManualClock(1_000_000)
    # The store's profiling seam times each host dispatch (resolve, pack,
    # upload, enqueue — not the device).
    session = ProfilingSession()
    store = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                  max_batch=BATCH, clock=clock,
                                  profiling_session=lambda: session)
    opts = pkg.TokenBucketOptions(token_limit=100, tokens_per_period=10,
                                  replenishment_period_s=1.0,
                                  instance_name="smoke")
    lim = pkg.PartitionedRateLimiter(opts, store)
    cap5 = pkg.PartitionedRateLimiter(
        pkg.TokenBucketOptions(token_limit=5, tokens_per_period=1,
                               instance_name="cap5"), store)
    await store.connect()
    # Time the host key→slot resolve inside the bulk dispatch.
    resolve_s = [0.0]
    _time_calls(store._table(opts.token_limit, opts.fill_rate_per_second).dir,
                "resolve_batch", resolve_s)
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    ck.reset_launches()

    # Bulk: 10M distinct keys, one permit each — every fresh bucket grants.
    t0 = time.perf_counter()
    res = await lim.acquire_many(range(N_KEYS), permits=1,
                                 with_remaining=False)
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    bulk_gc_s = gc_clock.total
    bulk_resolve_s = resolve_s[0]
    _INPROCESS_RESOLVE_S[0] = bulk_resolve_s
    if len(res) != N_KEYS or res.granted_count != N_KEYS:
        raise AssertionError(f"bulk: {res.granted_count}/{len(res)} granted")
    dispatch_s = sum(c.duration_s for c in session.finish())
    bulk_launches = dict(ck.launches)
    # A second bulk call on 1M of them reads back remaining: 100 - 1 - 1.
    sub = list(range(0, N_KEYS, 10))
    res = await lim.acquire_many(sub, permits=1)
    if not (res.granted.all() and np.all(res.remaining == 98.0)):
        raise AssertionError("bulk: second call's remaining is not 98")
    print(f"bulk acquire_many: {N_KEYS} distinct keys in {bulk_s:.3f} s = "
          f"{N_KEYS / bulk_s:.0f} decisions/s ({card}); host dispatch "
          f"{dispatch_s:.3f} s, of which key->slot resolve "
          f"{bulk_resolve_s:.3f} s; garbage collector {bulk_gc_s:.3f} s; "
          f"kernel launches {bulk_launches}")
    chunk = range(N_KEYS, N_KEYS + SCAN_K * BATCH)
    await trace_chunk(torch, ck, lim, chunk, card)

    # Flushes: cold keys (distinct rows) and hot keys (duplicates, grouped).
    rng = np.random.default_rng(SEED)
    cold = [int(k) for k in rng.choice(np.arange(1, N_KEYS, 10), 1000,
                                       replace=False)]  # 99 tokens left
    hot = [f"hot{i}" for i in range(20)]
    asks = [h for h in hot for _ in range(150)] + cold
    order = rng.permutation(len(asks))
    cap5.available_permits("h5")  # builds the cap-5 table outside the timing
    session.finish()
    flushes0 = store.metrics.flush_latency.total
    gc0 = gc_clock.total
    t0 = time.perf_counter()
    cold_leases = await asyncio.gather(*(lim.acquire_async(k) for k in cold))
    leases = await asyncio.gather(*(lim.acquire_async(asks[i])
                                    for i in order))
    five = await asyncio.gather(*(cap5.acquire_async("h5")
                                  for _ in range(32)))
    flush_s = time.perf_counter() - t0
    flush_gc_s = gc_clock.total - gc0
    n_flush = len(cold) + len(asks) + 32
    flushes = store.metrics.flush_latency.total - flushes0
    dispatch_s = sum(c.duration_s for c in session.finish())
    got = {}
    for i, lease in zip(order, leases):
        got[asks[i]] = got.get(asks[i], 0) + bool(lease)
    # Host oracle: no time passes, so each key grants min(asks, balance).
    want = {h: 100 for h in hot}
    want.update({k: 1 for k in cold})
    if not all(cold_leases) or got != want:
        raise AssertionError("flush grants disagree with the host oracle")
    if sum(map(bool, five)) != 5:
        raise AssertionError(f"cap-5 bucket granted {sum(map(bool, five))}")
    if lim.available_permits("hot0") != 0 or \
            lim.available_permits(cold[0]) != 97:
        raise AssertionError("available_permits disagrees with the oracle")
    print(f"acquire_async flushes: {n_flush} requests in {flush_s:.3f} s = "
          f"{n_flush / flush_s:.0f} decisions/s ({card}); grants exact; "
          f"{flushes} flushes, host dispatch {dispatch_s:.3f} s, flush p50 "
          f"{store.metrics.flush_latency.p50 * 1e3:.3f} ms, p99 "
          f"{store.metrics.flush_latency.p99 * 1e3:.3f} ms, garbage collector "
          f"{flush_gc_s:.3f} s")

    _check_native(store)
    # Sweep: past every bucket's time-to-full, every live slot expires.
    live = sum(len(t.dir) for t in store._tables.values())
    clock.advance_seconds(11.0)
    removed_s = [0.0]
    for t in store._tables.values():
        _time_calls(t.dir, "remove_slots", removed_s)
    gc0 = gc_clock.total
    t0 = time.perf_counter()
    store.sweep_all()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_gc_s = gc_clock.total - gc0
    if store.metrics.slots_evicted != live or \
            live != N_KEYS + len(chunk) + len(hot) + 1:
        raise AssertionError(f"sweep evicted {store.metrics.slots_evicted} "
                             f"of {live} live slots")
    print(f"sweep_all: evicted {live} slots in {sweep_s:.3f} s ({card}); "
          f"directory removal {removed_s[0]:.3f} s, garbage collector "
          f"{sweep_gc_s:.3f} s")
    counts = dict(ck.launches)
    gc.callbacks.remove(gc_clock)
    await store.aclose()
    return counts


class _CounterOracle:
    """Host float32 model of the counter table, indexed by key rank: each
    operation of the decay rounded on its own, in the kernel's order."""

    def __init__(self, n: int) -> None:
        self.value = np.zeros(n, np.float32)
        self.period = np.zeros(n, np.float32)
        self.last = np.zeros(n, np.int64)
        self.exists = np.zeros(n, bool)
        self.rate = np.float32(DECAY_PER_S / 1024)

    def decay(self, idx: np.ndarray, now: int):
        ex = self.exists[idx]
        delta = np.maximum(0, now - np.where(ex, self.last[idx], 0)).astype(
            np.float32)
        decayed = np.where(ex, np.maximum(np.float32(0), self.value[idx]
                                          - delta * self.rate),
                           np.float32(0)).astype(np.float32)
        period = np.where(ex, np.float32(0.8) * self.period[idx]
                          + np.float32(0.2) * delta, delta).astype(np.float32)
        return decayed, period

    def sync(self, idx: np.ndarray, counts: np.ndarray, now: int):
        """Rows may repeat: every row sees the pre-sync state, the adds
        accumulate. Returns the replies (decayed + own count, period)."""
        decayed, period = self.decay(idx, now)
        self.value[idx] = decayed
        self.period[idx] = period
        self.last[idx] = now
        self.exists[idx] = True
        np.add.at(self.value, idx, counts)
        return decayed + counts, period


def _check_replies(what, got, want) -> float:
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    if not err <= ATOL:
        raise AssertionError(f"{what}: max abs error {err} > {ATOL}")
    return err


async def approximate_path(torch, ck, pkg, card: str) -> dict:
    """BASELINE config 3, the approximate token bucket at 1M keys with
    Zipf(1.1) skew, on a store of its own; returns the kernel launches it
    made."""
    rng = np.random.default_rng(SEED + 3)
    clock = pkg.ManualClock(1_000_000)
    store = pkg.DeviceBucketStore(device="cuda", counter_slots=COUNTER_SLOTS,
                                  clock=clock)
    await store.connect()
    _check_native(store)
    keys = [f"tenant:{i}" for i in range(N_COUNTER_KEYS)]
    oracle = _CounterOracle(N_COUNTER_KEYS)
    ck.reset_launches()

    # 1. One fleet sync of 1M distinct counters: one launch. Host split:
    # native resolve, launch (wrapper call), pack + upload (the rest of the
    # dispatch), readback (the rest of the call: device time, copy, await).
    resolve_s, launch_s, dispatch_s = [0.0], [0.0], [0.0]
    _time_calls(store._counter_dir, "resolve_batch", resolve_s)
    _time_calls(store, "_sync_dispatch_many", dispatch_s)
    sync_fn = ck.sync_counters
    _time_calls(ck, "sync_counters", launch_s)
    counts = rng.uniform(0, 100, N_COUNTER_KEYS).astype(np.float32)
    t0 = time.perf_counter()
    scores, periods = await store.sync_counters_many(keys, counts,
                                                     DECAY_PER_S)
    fleet_s = time.perf_counter() - t0
    ck.sync_counters = sync_fn
    if ck.launches["sync_counters"] != 1:
        raise AssertionError(f"fleet sync: {ck.launches['sync_counters']} "
                             "launches, not one")
    want, want_p = oracle.sync(np.arange(N_COUNTER_KEYS), counts,
                               clock.now_ticks())
    if not (np.array_equal(scores, counts) and np.array_equal(scores, want)
            and np.array_equal(periods, want_p)):
        raise AssertionError("fleet sync: a score differs from its count")
    pack_s = dispatch_s[0] - resolve_s[0] - launch_s[0]
    print(f"fleet sync_counters_many: {N_COUNTER_KEYS} counters in "
          f"{fleet_s:.4f} s = {N_COUNTER_KEYS / fleet_s:.0f} counters/s "
          f"({card}); native resolve {resolve_s[0]:.4f} s, pack + upload "
          f"{pack_s:.4f} s, launch {launch_s[0]:.4f} s, readback "
          f"{fleet_s - dispatch_s[0]:.4f} s; every score equals its count")

    # 2. Zipf(1.1) rounds, pre-aggregated per key with np.unique.
    err, n_rows, rounds_s = 0.0, 0, 0.0
    for _ in range(COUNTER_ROUNDS):
        clock.advance_seconds(0.25)
        ranks = (rng.zipf(ZIPF_S, ROUND_DRAWS) - 1) % N_COUNTER_KEYS
        uniq, inv = np.unique(ranks, return_inverse=True)
        agg = np.bincount(inv, weights=rng.uniform(0, 4, ROUND_DRAWS)).astype(
            np.float32)
        batch = [keys[i] for i in uniq]
        t0 = time.perf_counter()
        scores, periods = await store.sync_counters_many(batch, agg,
                                                         DECAY_PER_S)
        rounds_s += time.perf_counter() - t0
        want, want_p = oracle.sync(uniq, agg, clock.now_ticks())
        err = max(err, _check_replies("Zipf round scores", scores, want),
                  _check_replies("Zipf round periods", periods, want_p))
        n_rows += len(uniq)
    print(f"{COUNTER_ROUNDS} Zipf({ZIPF_S}) rounds of {ROUND_DRAWS} draws "
          f"({n_rows} aggregated rows) in {rounds_s:.4f} s = "
          f"{n_rows / rounds_s:.0f} counters/s; replies within {err:.3g} of "
          f"the host oracle")

    # 3. One round left unaggregated: duplicates share the decayed value,
    # each reply adds its own count, the adds accumulate.
    clock.advance_seconds(0.25)
    ranks = (rng.zipf(ZIPF_S, ROUND_DRAWS) - 1) % N_COUNTER_KEYS
    raw = rng.uniform(0, 4, ROUND_DRAWS).astype(np.float32)
    scores, periods = await store.sync_counters_many(
        [keys[i] for i in ranks], raw, DECAY_PER_S)
    want, want_p = oracle.sync(ranks, raw, clock.now_ticks())
    dup_err = max(_check_replies("duplicate round scores", scores, want),
                  _check_replies("duplicate round periods", periods, want_p))
    uniq, inv, reps = np.unique(ranks, return_inverse=True,
                                return_counts=True)
    slots = store._counter_dir.resolve_batch([keys[i] for i in uniq])
    value = store._counters.value[torch.from_numpy(slots).long().to(
        store.device)].cpu().numpy()
    value_err, value_tol = _check_repeated_adds(
        "duplicate round values", inv, value, oracle.value[uniq])
    print(f"unaggregated round: {ROUND_DRAWS} rows on {len(uniq)} keys "
          f"(hottest {reps.max()} times): replies within {dup_err:.3g}, "
          f"values within their per-key limits, largest error {value_err!r} "
          f"(that key's limit {value_tol!r})")

    # 4. Eight approximate limiters sharing one counter, syncing at a
    # staggered cadence.
    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        overadmit_epsilon,
    )

    n_lim, limit, rate = 8, 100, 10
    opts = pkg.ApproximateTokenBucketOptions(
        token_limit=limit, tokens_per_period=rate, replenishment_period_s=1.0,
        instance_name="fleet-limiter")
    lims = [pkg.ApproximateTokenBucketRateLimiter(opts, store)
            for _ in range(n_lim)]
    # The counter is fresh, so its first interval is the whole epoch (~1e6
    # ticks); ten rounds (80 syncs, each keeping 0.8 of the EWMA) bring the
    # average down to the 128-tick cadence.
    for _ in range(10):
        for lim in lims:
            clock.advance_seconds(1.0 / n_lim)
            await lim.refresh()
    estimates = [lim._instance_count for lim in lims]
    if estimates != [n_lim] * n_lim:
        raise AssertionError(f"instance estimates {estimates}, not 8")
    per_period = []
    for _ in range(12):
        grants = 0
        for lim in lims:
            while lim.acquire(1).is_acquired:
                grants += 1
            clock.advance_seconds(1.0 / n_lim)
            await lim.refresh()
        per_period.append(grants)
    bound = limit + overadmit_epsilon(0.0, rate, 1.0)
    if max(per_period) > bound:
        raise AssertionError(f"grants per period {per_period} > {bound}")
    for lim in lims:
        await lim.aclose()
    print(f"8 approximate limiters on one counter: instance estimates "
          f"{estimates}; grants per period {per_period} (bound {bound:g})")

    # 5. A day later every counter has expired: sweep_all evicts them all.
    live = len(store._counter_dir)
    clock.advance_seconds(86_401)
    removed_s = [0.0]
    _time_calls(store._counter_dir, "remove_slots", removed_s)
    evicted0 = store.metrics.slots_evicted
    t0 = time.perf_counter()
    store.sweep_all()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    evicted = store.metrics.slots_evicted - evicted0
    if evicted != live or len(store._counter_dir) != 0 or \
            live != N_COUNTER_KEYS + 1:
        raise AssertionError(f"counter sweep evicted {evicted} of {live}")
    print(f"counter sweep_all: evicted {live} counters in {sweep_s:.4f} s; "
          f"directory removal {removed_s[0]:.4f} s")
    counts = dict(ck.launches)
    await store.aclose()
    return counts


#: Wall seconds of the in-process main path's key→slot resolve (strings),
#: set by ``main_path`` and printed beside the server's key-blob resolve.
_INPROCESS_RESOLVE_S = [0.0]
#: Extra arguments for the console server (the CPU rehearsal adds
#: ``--device cpu``; on the card it runs with none, so on ``cuda``).
CLI_EXTRA_ARGS: list = []


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


async def _scalar_round(lim, keys, order, workers):
    """One round of ``acquire_async``: ``workers`` tasks take the keys in
    ``order``; returns per-key grants and per-request latencies (s)."""
    it = iter(order)
    grants = np.zeros(len(keys), np.int64)
    lat = []

    async def worker():
        for i in it:
            t = time.perf_counter()
            lease = await lim.acquire_async(keys[i])
            lat.append(time.perf_counter() - t)
            grants[i] += bool(lease)

    await asyncio.gather(*(worker() for _ in range(workers)))
    return grants, lat


async def scalar_client(pkg, addr, n_keys: int) -> dict:
    """The server path's scalar phase, run in a process of its own as a
    client host would: ``acquire_async`` through ``PartitionedRateLimiter``
    over ``RemoteBucketStore``s, 64 tasks, ``n_keys`` uniform keys, token
    limit 10, 20 asks per key on the server's unadvanced clock. Rounds
    alternate between a coalescing client (ACQUIRE_MANY flushes →
    acquire_scan) and a per-request one (OP_ACQUIRE → acquire_packed); the
    first 10 rounds must grant every ask and the last 10 deny every ask, so
    each key grants min(10, 20) = 10. Returns the grants, and per client the
    rate, the latencies and the frames it sent."""
    from distributedratelimiting.redis_tpu_torch.runtime import wire

    frames = [0]
    write_frame = wire.write_frame

    def counted(writer, data):
        frames[0] += 1
        write_frame(writer, data)

    wire.write_frame = counted
    opts = pkg.TokenBucketOptions(token_limit=SCALAR_LIMIT,
                                  tokens_per_period=1,
                                  replenishment_period_s=1.0,
                                  instance_name="scalar")
    stores = {lane: pkg.RemoteBucketStore(
        address=addr, coalesce_requests=lane == "coalesced")
        for lane in SCALAR_LANES}
    lims = {lane: pkg.PartitionedRateLimiter(opts, st)
            for lane, st in stores.items()}
    keys = list(range(n_keys))
    rng = np.random.default_rng(SEED + 2)
    total = np.zeros(n_keys, np.int64)
    clients = {lane: {"requests": 0, "wall_s": 0.0, "frames": 0, "lat": []}
               for lane in SCALAR_LANES}
    rounds = []
    for r in range(SCALAR_ASKS):
        lane = SCALAR_LANES[r % 2]
        c = clients[lane]
        f0 = frames[0]
        t0 = time.perf_counter()
        grants, lat = await _scalar_round(lims[lane], keys,
                                          rng.permutation(n_keys),
                                          SCALAR_TASKS)
        c["wall_s"] += time.perf_counter() - t0
        c["frames"] += frames[0] - f0
        c["requests"] += n_keys
        c["lat"] += lat
        rounds.append((lane, np.unique(grants).tolist()))
        total += grants
    for st in stores.values():
        await st.aclose()
    for c in clients.values():
        lat = c.pop("lat")
        c["p50_ms"], c["p99_ms"] = _pct(lat, 50) * 1e3, _pct(lat, 99) * 1e3
    return {"rounds": rounds, "totals": np.unique(total).tolist(),
            "clients": clients}


async def server_path(torch, ck, pkg, card: str) -> dict:
    """The shared store server (README "Multi-host"; BASELINE config 2's
    shape): a ``BucketStoreServer`` over a ``DeviceBucketStore`` on the card
    at the main path's size, limiters on ``RemoteBucketStore`` clients.
    Returns the kernel launches the path made."""
    clock = pkg.ManualClock(1_000_000)
    store = pkg.DeviceBucketStore(device="cuda", n_slots=N_SLOTS,
                                  counter_slots=COUNTER_SLOTS,
                                  max_batch=BATCH, clock=clock)
    server = pkg.BucketStoreServer(store, host="127.0.0.1", port=0)
    host, port = await server.start()
    addr = (host, port)
    opts = pkg.TokenBucketOptions(token_limit=100, tokens_per_period=10,
                                  replenishment_period_s=1.0,
                                  instance_name="wire")
    # The table exists before the timing, so its key-blob resolve is timed.
    table = store._table(opts.token_limit, opts.fill_rate_per_second)
    resolve_s = [0.0]
    _time_calls(table.dir, "resolve_batch", resolve_s)
    bulk_cli = pkg.RemoteBucketStore(address=addr, request_timeout_s=600.0)
    co = pkg.RemoteBucketStore(address=addr, clock=clock)
    solo = pkg.RemoteBucketStore(address=addr, clock=clock,
                                 coalesce_requests=False)
    ck.reset_launches()

    # 1. Bulk over the wire: 10M distinct keys as ACQUIRE_MANY frames
    # (chained chunks under MAX_FRAME), resolved from each frame's bytes.
    lim = pkg.PartitionedRateLimiter(opts, bulk_cli)
    frames0 = server.requests_served
    t0 = time.perf_counter()
    res = await lim.acquire_many(range(N_KEYS), permits=1,
                                 with_remaining=False)
    bulk_s = time.perf_counter() - t0
    frames = server.requests_served - frames0
    if len(res) != N_KEYS or res.granted_count != N_KEYS:
        raise AssertionError(f"wire bulk: {res.granted_count}/{len(res)} "
                             "granted")
    sub = range(0, N_KEYS, 10)
    res = await lim.acquire_many(sub, permits=1)
    if not (res.granted.all() and np.all(res.remaining == 98.0)):
        raise AssertionError("wire bulk: second call's remaining is not 98")
    print(f"server bulk acquire_many over the wire: {N_KEYS} distinct keys "
          f"in {bulk_s:.3f} s = {N_KEYS / bulk_s:.0f} decisions/s ({card}); "
          f"{frames} ACQUIRE_MANY frames; server key-blob resolve "
          f"{resolve_s[0]:.3f} s for {N_KEYS + len(sub)} keys (in-process "
          f"path's string resolve {_INPROCESS_RESOLVE_S[0]:.3f} s for "
          f"{N_KEYS}); every grant and remaining checked")

    # 2. Scalar acquire_async, BASELINE config 2's shape, from a client
    # process of its own (a client host; see scalar_client).
    await co.stats(reset=True)
    frames0 = server.requests_served
    t0 = time.perf_counter()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, os.path.abspath(__file__), "--scalar-client", host,
        str(port), str(N_SCALAR_KEYS), stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), 900)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    phase_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"scalar client exited {proc.returncode}: "
                             f"{err.decode()[-3000:]}")
    rep = json.loads(out.decode().strip().splitlines()[-1])
    for r, (lane, values) in enumerate(rep["rounds"]):
        want = 1 if r < SCALAR_LIMIT else 0
        if values != [want]:
            raise AssertionError(f"scalar round {r} ({lane}): grants per "
                                 f"key {values}, not all {want}")
    if rep["totals"] != [min(SCALAR_LIMIT, SCALAR_ASKS)]:
        raise AssertionError(f"scalar grants per key {rep['totals']} differ "
                             "from min(limit, asks)")
    stats = await co.stats()
    for lane, c in rep["clients"].items():
        print(f"server scalar acquire_async ({lane} client, {SCALAR_TASKS} "
              f"tasks): {c['requests']} requests in {c['wall_s']:.3f} s = "
              f"{c['requests'] / c['wall_s']:.0f} requests/s ({card}); "
              f"client p50 {c['p50_ms']:.3f} ms, p99 {c['p99_ms']:.3f} ms; "
              f"{c['frames']} frames sent")
    stages = "; ".join(f"{k} p50 {v['p50_ms']:.3f} ms, p99 "
                       f"{v['p99_ms']:.3f} ms"
                       for k, v in stats.get("stages", {}).items())
    print(f"server scalar: {phase_s:.3f} s with the client process's start; "
          f"grants per key exactly min(10, 20) for {N_SCALAR_KEYS} keys "
          f"(every round all granted, then all denied); server (OP_STATS) "
          f"serving p50 {stats['serving_p50_ms']:.3f} ms, p99 "
          f"{stats['serving_p99_ms']:.3f} ms over {stats['serving_samples']} "
          f"frames ({server.requests_served - frames0} served); stages: "
          f"{stages}")
    # Cap-5 × 32 over the wire, on both lanes (duplicates in one flush).
    for name, cli in (("per-request", solo), ("coalesced", co)):
        cap5 = pkg.PartitionedRateLimiter(
            pkg.TokenBucketOptions(token_limit=5, tokens_per_period=1,
                                   instance_name=f"cap5-{name}"), cli)
        five = await asyncio.gather(*(cap5.acquire_async("h5")
                                      for _ in range(32)))
        if sum(map(bool, five)) != 5:
            raise AssertionError(f"cap-5 over the wire ({name}) granted "
                                 f"{sum(map(bool, five))}")
    print("server cap-5 bucket x 32 asks: 5 granted on both lanes")

    # 3. Counter syncs: eight approximate limiters on one key over one
    # remote store, held to the approximate path's bound.
    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        overadmit_epsilon,
    )

    n_lim, limit, rate = 8, 100, 10
    aopts = pkg.ApproximateTokenBucketOptions(
        token_limit=limit, tokens_per_period=rate, replenishment_period_s=1.0,
        instance_name="wire-fleet")
    alims = [pkg.ApproximateTokenBucketRateLimiter(aopts, solo)
             for _ in range(n_lim)]
    for _ in range(10):
        for a in alims:
            clock.advance_seconds(1.0 / n_lim)
            await a.refresh()
    estimates = [a._instance_count for a in alims]
    if estimates != [n_lim] * n_lim:
        raise AssertionError(f"wire instance estimates {estimates}, not 8")
    per_period = []
    for _ in range(12):
        grants = 0
        for a in alims:
            while a.acquire(1).is_acquired:
                grants += 1
            clock.advance_seconds(1.0 / n_lim)
            await a.refresh()
        per_period.append(grants)
    bound = limit + overadmit_epsilon(0.0, rate, 1.0)
    if max(per_period) > bound:
        raise AssertionError(f"wire grants per period {per_period} > "
                             f"{bound}")
    for a in alims:
        await a.aclose()
    print(f"server OP_SYNC: 8 approximate limiters on one counter, instance "
          f"estimates {estimates}; grants per period {per_period} (bound "
          f"{bound:g})")

    # 4. The periodic sweeper: a day later every bucket and the counter
    # have expired; the sweeper (every 0.5 s) evicts exactly them.
    _check_native(store)
    live = sum(len(t.dir) for t in store._tables.values())
    want_live = N_KEYS + N_SCALAR_KEYS + 2
    if live != want_live:
        raise AssertionError(f"server holds {live} buckets, not {want_live}")
    live += len(store._counter_dir)
    evicted0 = store.metrics.slots_evicted
    store.start_sweeper(0.5)
    clock.advance_seconds(86_401)
    t0 = time.perf_counter()
    while (store.metrics.slots_evicted - evicted0 < live
           and time.perf_counter() - t0 < 120):
        await asyncio.sleep(0.05)
    waited = time.perf_counter() - t0
    evicted = store.metrics.slots_evicted - evicted0
    left = sum(len(t.dir) for t in store._tables.values()) + len(
        store._counter_dir)
    if evicted != live or left:
        raise AssertionError(f"sweeper evicted {evicted} of {live} ({left} "
                             "left)")
    print(f"server periodic sweeper (0.5 s): evicted exactly {live} slots "
          f"within {waited:.3f} s of the clock passing their TTL")
    for cli in (bulk_cli, co, solo):
        await cli.aclose()
    await server.aclose()
    await store.aclose()
    if store._sweeper_task is not None:
        raise AssertionError("aclose left the sweeper running")
    counts = dict(ck.launches)
    print(f"server path kernel launches: {counts}")
    return counts


def cli_server(pkg) -> None:
    """The console entry point on the card: start it (no ``--device``, so
    ``cuda``), read its listening line, ping, cap-5 × 32 → 5, check that
    ``OP_STATS`` has the JAX server's keys, SIGTERM → exit 0."""
    import select
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m",
           "distributedratelimiting.redis_tpu_torch.runtime.server",
           "--port", "0", "--slots", "1048576", "--sweep-period", "1",
           *CLI_EXTRA_ARGS]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        line = proc.stdout.readline() if ready else ""
        prefix = "bucket-store server listening on "
        if not line.startswith(prefix):
            proc.kill()
            raise AssertionError(f"console server printed {line!r}; stderr "
                                 f"{proc.communicate()[1][-2000:]!r}")
        start_s = time.perf_counter() - t0
        host, port = line[len(prefix):].strip().rsplit(":", 1)

        async def drive():
            cli = pkg.RemoteBucketStore(address=(host, int(port)))
            await cli.ping()
            res = await asyncio.gather(*(cli.acquire("five", 1, 5.0, 1.0)
                                         for _ in range(32)))
            stats = await cli.stats()
            await cli.aclose()
            return sum(r.granted for r in res), stats

        granted, stats = asyncio.run(drive())
        if granted != 5:
            raise AssertionError(f"console server: cap-5 granted {granted}")
        keys = {"connections_served", "requests_served", "serving_p50_ms",
                "serving_p99_ms", "serving_samples", "requests_shed",
                "stats_resets", "store"}
        if not keys <= set(stats):
            raise AssertionError(f"console server OP_STATS lacks "
                                 f"{keys - set(stats)}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        if rc != 0:
            raise AssertionError(f"console server exited {rc} on SIGTERM")
        print(f"console server ({' '.join(cmd[2:])}): listening after "
              f"{start_s:.1f} s, ping, cap-5 x 32 -> 5, OP_STATS keys "
              f"present, SIGTERM -> exit 0 in {time.perf_counter() - t1:.2f} "
              "s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distributedratelimiting.redis_tpu_torch as pkg
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
    from distributedratelimiting.redis_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card_line()
    print(card)
    t0 = time.perf_counter()
    report = ck.build()
    print(f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    with open(ck.BUILD_DIR / "nvcc.log", "w") as f:
        for name, r in report.items():
            f.write(f"== {name} ({r['seconds']:.1f} s)\n{r['log']}\n")

    dev = torch.device("cuda")
    phases = {}
    t = time.perf_counter()
    res = kernel_phase(torch, K, ck, dev)
    phases["kernels"] = time.perf_counter() - t
    # Each path resets the counts just before it runs and reads them just
    # after; a kernel's launches are its count summed over the paths, and
    # it must have launched on the path it serves.
    by_path = {}
    for name, path in (("exact", main_path), ("approximate", approximate_path),
                       ("server", server_path)):
        t = time.perf_counter()
        by_path[name] = asyncio.run(path(torch, ck, pkg, card))
        phases[name] = time.perf_counter() - t
    t = time.perf_counter()
    cli_server(pkg)
    phases["console server"] = time.perf_counter() - t
    print("phase wall seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()))
    serves = {"sweep_expired": "exact", "acquire_packed": "exact",
              "acquire_grouped": "exact", "acquire_scan": "exact",
              "sync_counters": "approximate", "sweep_counters": "approximate"}

    sources = {"sweep_expired": "csrc/sweep.cu",
               "acquire_packed": "csrc/acquire.cu",
               "acquire_grouped": "csrc/acquire.cu",
               "acquire_scan": "csrc/acquire.cu",
               "sync_counters": "csrc/counter.cu",
               "sweep_counters": "csrc/counter.cu"}
    replaces = {
        "sweep_expired":
            "distributedratelimiting/redis_tpu/ops/pallas_kernels.py:80",
        "acquire_packed":
            "distributedratelimiting/redis_tpu/ops/kernels.py:239",
        "acquire_grouped":
            "distributedratelimiting/redis_tpu/ops/kernels.py:257",
        # acquire_scan_fused_packed; also _bits (:451) and
        # acquire_scan_compact_packed (:383).
        "acquire_scan":
            "distributedratelimiting/redis_tpu/ops/kernels.py:479",
        # core _sync_core (:728)
        "sync_counters":
            "distributedratelimiting/redis_tpu/ops/kernels.py:1085",
        "sweep_counters":
            "distributedratelimiting/redis_tpu/ops/kernels.py:1220",
    }
    kernels = []
    for name, r in res.items():
        bound_ms, bound_by = _bound_ms(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distributedratelimiting/redis_tpu_torch/"
                      + sources[name],
            "replaces": replaces[name],
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    # The server path drives every kernel.
    idle = [f"{name} ({path} path)" for name, path in serves.items()
            if by_path[path][name] <= 0]
    idle += [f"{name} (server path)" for name in serves
             if by_path["server"][name] <= 0]
    if idle:
        raise AssertionError(f"never launched: {idle}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scalar-client"]:
        # A client process of the server path (see scalar_client).
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import distributedratelimiting.redis_tpu_torch as _pkg

        print(json.dumps(asyncio.run(scalar_client(
            _pkg, (sys.argv[2], int(sys.argv[3])), int(sys.argv[4])))))
        sys.exit(0)
    sys.exit(main())
