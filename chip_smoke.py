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
   (the main path's bulk). Grants, bits, masks, ``exists`` and ``last_ts`` must
   be equal; remaining and tokens within atol 1e-4. Time each (median of
   CUDA-event timings, and device time from ``torch.profiler``) beside the
   plain version and the bound.
3. The main path at full size: ``PartitionedRateLimiter`` over
   ``DeviceBucketStore(device="cuda", n_slots=2**24)`` — ``acquire_many``
   over 10,000,000 distinct keys, one more bulk chunk under
   ``torch.profiler`` (its device busy share and kernel launches),
   concurrent ``acquire_async`` on hot and cold keys checked against a host
   oracle (cap-5 bucket × 32 asks → 5), then ``sweep_all`` past the TTL
   with an exact eviction count. Each phase prints its rate and where its
   host time went (the store's dispatch spans, the key directory, Python's
   garbage collector).
4. Print ``{"kernels": [...]}``: per kernel its launches on the main path
   (each must be > 0), the error against the plain version, and its times.
5. Last line: ``{"ok": true, "device": {...}}``.

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
ATOL = 1e-4
#: H100 SXM device-memory rate and float32 rate outside the tensor cores
#: (NVIDIA data sheet, at the 700 W limit), for the bound.
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPS = 30


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
    return res


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
    res = kernel_phase(torch, K, ck, dev)
    launches = asyncio.run(main_path(torch, ck, pkg, card))

    sources = {"sweep_expired": "csrc/sweep.cu",
               "acquire_packed": "csrc/acquire.cu",
               "acquire_grouped": "csrc/acquire.cu",
               "acquire_scan": "csrc/acquire.cu"}
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
    }
    kernels = []
    for name, r in res.items():
        bound_ms, bound_by = _bound_ms(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distributedratelimiting/redis_tpu_torch/"
                      + sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"main path never launched {idle}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
