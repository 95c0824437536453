"""The port's observability plane, held to the JAX package on seeded inputs.

- ``utils/metrics.py``: the same registry contents (counters, gauges,
  histograms with exemplars, labeled families with escaping, numeric
  dicts) render byte for byte as JAX's, with and without exemplars;
  ``parse_openmetrics`` and ``aggregate_openmetrics`` give equal results;
  ``LatencyHistogram`` quantiles, counts and bucket bounds are equal on
  seeded samples.
- ``utils/heavy_hitters.py``: ``top()`` equal on seeded Zipf streams through
  every feed (``offer``, ``offer_buffered``, ``offer_many``, ``offer_blob``),
  with the port's one repair: a read drains a partial buffer whole, where
  JAX's keeps its top ``batch_top`` keys (the JAX sketch's pending buffer
  is drained the port's way before it is read; with at most ``batch_top``
  distinct keys pending the two drains are one). The repaired drain never
  undercounts a key: seeded reads at random points of a buffered Zipf
  stream leave every count at or above the key's true count.
- ``utils/flight_recorder.py``: dumps equal byte for byte on one frame
  stream and one clock.
- ``utils/tracing.py``: Chrome export equal to JAX's for the same spans;
  the device seam's ``drl/<command>`` ranges are in a CPU ``torch.profiler``
  trace of a store's dispatches (``start_device_trace`` /
  ``stop_device_trace``), and ``annotate=False`` spans are not.
- The server: the port's and JAX's served the same seeded trace give equal
  ``OP_METRICS`` counter values, and the port renders no family JAX does
  not; the JAX client reads the port server's ``OP_METRICS``,
  ``OP_TRACES`` (``server.*`` spans under the client's trace ids) and
  ``OP_AUDIT``; ``/metrics`` (content negotiation), ``/flight``,
  ``/traces``; one flush failure injected at the ``store.flush`` seam gives
  exactly one ``flush_error`` dump holding the flush frames.

Tolerance 0 everywhere but wall-time readings, which are not compared.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import types

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.remote import (
    RemoteBucketStore as JRemote,
)
from distributedratelimiting.redis_tpu.runtime.server import (
    BucketStoreServer as JServer,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    InProcessBucketStore as JInProcess,
)
from distributedratelimiting.redis_tpu.utils import flight_recorder as jfr
from distributedratelimiting.redis_tpu.utils import heavy_hitters as jhh
from distributedratelimiting.redis_tpu.utils import metrics as jm
from distributedratelimiting.redis_tpu.utils import tracing as jtracing
from distributedratelimiting.redis_tpu_torch import (
    BucketStoreServer,
    DeviceBucketStore,
    FingerprintBucketStore,
    ManualClock,
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.runtime import wire
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    InProcessBucketStore,
)
from distributedratelimiting.redis_tpu_torch.utils import faults
from distributedratelimiting.redis_tpu_torch.utils import flight_recorder as pfr
from distributedratelimiting.redis_tpu_torch.utils import heavy_hitters as phh
from distributedratelimiting.redis_tpu_torch.utils import metrics as pm
from distributedratelimiting.redis_tpu_torch.utils import tracing

LIMIT_S = 30.0
START = 1 << 20


@pytest.fixture
def frozen_wall(monkeypatch):
    """One wall clock for both packages' metrics modules: exemplars carry
    the wall time they were taken at."""
    clock = types.SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(pm, "time", clock)
    monkeypatch.setattr(jm, "time", clock)


# -- metrics ------------------------------------------------------------------

def _latencies(seed: int, n: int = 2000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(-7.0, 1.5, n),
                           [0.0, 1e-9, 1e3, 5e-6]])


def _histogram(mod, seed: int):
    h = mod.LatencyHistogram()
    for i, s in enumerate(_latencies(seed)):
        h.record(float(s), trace_id=f"{i:032x}" if i % 97 == 0 else None)
    h.exemplar(0.0031, "f" * 32)
    return h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_match_jax(seed, frozen_wall):
    mine, theirs = _histogram(pm, seed), _histogram(jm, seed)
    assert mine.counts == theirs.counts
    assert mine.total == theirs.total and mine.sum_s == theirs.sum_s
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert mine.quantile(q) == theirs.quantile(q)
    assert (mine.p50, mine.p99) == (theirs.p50, theirs.p99)
    assert (pm.LatencyHistogram.bucket_upper_bounds()
            == jm.LatencyHistogram.bucket_upper_bounds())
    assert mine.exemplars == theirs.exemplars
    mine.reset()
    theirs.reset()
    assert (mine.resets, mine.total) == (theirs.resets, theirs.total) == (1, 0)


def _registry(mod, seed: int):
    """One registry of every family kind over seeded values."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 10**6, 8).tolist()
    floats = (rng.random(6) * 1e3).tolist()
    reg = mod.MetricsRegistry()
    reg.counter("requests_served", "Requests answered", lambda: vals[0])
    reg.counter("tokens", "Float counter", lambda: floats[0])
    reg.gauge("depth", "A gauge", lambda: floats[1])
    reg.gauge("flag", "A bool gauge", lambda: True)
    reg.gauge("big", "A large float", lambda: 2.0**60 + 0.5)
    h = _histogram(mod, seed)
    reg.histogram("serving_latency_seconds", "Latency", lambda: h)
    reg.histogram("stage_latency_seconds", "Stages", lambda: h,
                  labels={"stage": "queue"})
    reg.histogram("stage_latency_seconds", "Stages", lambda: None,
                  labels={"stage": "flush"})
    reg.labeled_gauges(
        "hot_key_count", "Per key",
        lambda: [({"key": 'we"ird\\key\nline'}, floats[2]),
                 ({"key": "plain"}, vals[1])])
    reg.labeled_counters(
        "actions", "Per action",
        lambda: [({"action": "split", "outcome": "ok"}, vals[2])])
    reg.register_numeric_dict(
        "store", "store metrics",
        lambda: {"launches": vals[3], "rows_valid": vals[4],
                 "batch_occupancy": floats[3], "nested": {"x": 1},
                 "name": "skip", "ok": True},
        counters={"launches", "rows_valid"})
    reg.register_numeric_dict("absent", "absent dict", lambda: None)
    reg.register_numeric_dict("node", "labeled dict",
                              lambda: {"x": floats[4]},
                              labels={"shard": "3"})
    return reg


@pytest.mark.parametrize("seed", [0, 5])
def test_registry_renders_byte_for_byte(seed, frozen_wall):
    mine, theirs = _registry(pm, seed), _registry(jm, seed)
    for exemplars in (True, False):
        assert mine.render(exemplars=exemplars) == theirs.render(
            exemplars=exemplars)
    assert pm.MetricsRegistry.CONTENT_TYPE == jm.MetricsRegistry.CONTENT_TYPE
    with pytest.raises(ValueError):
        mine.gauge("requests_served", "retyped", lambda: 0)


def test_parse_and_aggregate_match_jax(frozen_wall):
    texts = [_registry(jm, seed).render() for seed in range(3)]
    for text in texts:
        assert pm.parse_openmetrics(text) == jm.parse_openmetrics(text)
    assert (pm.aggregate_openmetrics(texts)
            == jm.aggregate_openmetrics(texts))
    assert (pm.aggregate_openmetrics(texts, node_label="host")
            == jm.aggregate_openmetrics(texts, node_label="host"))


def test_counter_deltas_match_jax():
    mine, theirs = pm.CounterDeltas(max_keys=4), jm.CounterDeltas(max_keys=4)
    rng = np.random.default_rng(9)
    for _ in range(200):
        key = f"k{int(rng.integers(0, 6))}"
        value = float(rng.integers(0, 100))
        assert mine.delta(key, value) == theirs.delta(key, value)
    assert len(mine) == len(theirs)


# -- heavy hitters ------------------------------------------------------------

def _zipf_keys(seed: int, n: int, n_keys: int = 5000) -> list[str]:
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.1, n), n_keys) - 1
    return [f"user{i}" for i in ids]


@pytest.mark.parametrize("seed", [0, 1])
def test_heavy_hitters_top_matches_jax(seed):
    keys = _zipf_keys(seed, 30_000)
    rng = np.random.default_rng(seed + 100)
    costs = rng.integers(1, 5, len(keys)).astype(np.float64)
    mine, theirs = phh.HeavyHitters(64), jhh.HeavyHitters(64)
    for sk in (mine, theirs):
        for k in keys[:5000]:
            sk.offer_buffered(k)
        for k, c in zip(keys[5000:8000], costs[5000:8000]):
            sk.offer(k, float(c))
        sk.offer_many(keys[8000:20000], costs[8000:20000])
        sub = keys[20000:]
        blob, offsets = wire.pack_keys(sub) if hasattr(
            wire, "pack_keys") else _pack(sub)
        sk.offer_blob(blob, offsets, costs[20000:])
    _drain_whole(theirs)
    assert mine.top() == theirs.top()
    assert mine.snapshot() == theirs.snapshot()
    assert mine.offered == theirs.offered
    # Space-saving's contract against the exact counts of the exactly fed
    # part (offer/offer_buffered): count - error <= true <= count.
    exact: dict[str, float] = {}
    for k in keys[:5000]:
        exact[k] = exact.get(k, 0.0) + 1.0
    small = phh.HeavyHitters(64)
    for k in keys[:5000]:
        small.offer(k)
    for k, count, err in small.top():
        assert count - err <= exact[k] <= count
    for k, c in exact.items():
        if c > 5000 / 64:
            assert k in {t[0] for t in small.top()}


def _drain_whole(sketch) -> None:
    """The port's read-time drain on a JAX sketch: the pending buffer
    merged whole, in ``offer_many``'s order."""
    from collections import Counter

    buf, sketch._buf = sketch._buf, []
    for key, c in Counter(buf).most_common():
        sketch.offer(key, float(c))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_heavy_hitters_reads_lose_nothing(seed):
    """Reads at seeded random points of a buffered Zipf stream (every
    scrape drains): each key's count stays at or above its true count, and
    every key above N/K is tracked; the offered weight equals JAX's."""
    keys = _zipf_keys(seed, 40_000, n_keys=20_000)
    rng = np.random.default_rng(seed + 7)
    reads = np.sort(rng.choice(len(keys), 60, replace=False))
    mine = phh.HeavyHitters(64)
    theirs = jhh.HeavyHitters(64)
    for i, k in enumerate(keys):
        mine.offer_buffered(k)
        theirs.offer_buffered(k)
        if i in reads:
            mine.top()
            theirs.top()
    exact: dict[str, int] = {}
    for k in keys:
        exact[k] = exact.get(k, 0) + 1
    top = mine.top()
    assert all(count >= exact[k] >= count - err for k, count, err in top)
    heavy = {k for k, c in exact.items() if c > len(keys) / 64}
    assert heavy and heavy <= {k for k, _c, _e in top}
    theirs.top()
    assert mine.offered == theirs.offered == len(keys)


def _pack(keys: list[str]):
    data = [k.encode() for k in keys]
    offsets = np.zeros(len(data) + 1, np.int64)
    offsets[1:] = np.cumsum([len(d) for d in data])
    return b"".join(data), offsets


# -- flight recorder ----------------------------------------------------------

class _FakeTime:
    """One clock for both recorders: wall and monotonic seconds stepping
    by a fixed amount per read."""

    def __init__(self):
        self.t = 1.7e9

    def time(self):
        self.t += 0.25
        return self.t

    def monotonic(self):
        return self.t - 1.6e9


def test_flight_recorder_dumps_match_jax(tmp_path, monkeypatch):
    dumps = []
    for mod, sub in ((pfr, "port"), (jfr, "jax")):
        monkeypatch.setattr(mod, "time", _FakeTime())
        d = tmp_path / sub
        d.mkdir()
        fr = mod.FlightRecorder(capacity=16, dump_dir=str(d),
                                min_dump_interval_s=30.0)
        rng = np.random.default_rng(3)
        for i in range(40):
            fr.record("flush", n=int(rng.integers(1, 4096)),
                      wall_ms=round(float(rng.random()), 3),
                      error=None if i % 7 else "boom", trace_id=None)
        fr.record("audit", event="conservation_breach", residues={"x": 1.5})
        first = fr.auto_dump("flush_error", {"error": "boom"})
        assert fr.auto_dump("flush_error") is None  # rate-limited
        forced = fr.dump("stats_trigger")
        dumps.append(([open(p).read() for p in (first, forced)],
                      sorted(os.listdir(d)), fr.snapshot()))
    (mine, mine_names, mine_snap), (theirs, theirs_names, theirs_snap) = dumps
    assert mine == theirs and mine_names == theirs_names
    for snap in (mine_snap, theirs_snap):
        snap.pop("dump_dir")
        snap.pop("last_dump_path")
    assert mine_snap == theirs_snap
    header, *frames = [json.loads(line) for line in mine[0].splitlines()]
    assert header["reason"] == "flush_error" and len(frames) == 16
    assert set(pfr.REGISTERED_KINDS) == set(jfr.REGISTERED_KINDS)


# -- tracing ------------------------------------------------------------------

def _spans(mod):
    """One traced tree, same ids and stamps on both packages."""
    tr = mod.Tracer(enabled=True, sample_rate=1.0, keep_rate=1.0,
                    latency_threshold_s=10.0)
    tr._wall_base = 1.7e9
    ctx = mod.TraceContext(0xABC, 0xDEF, 7, 1)
    tr.record_span("server.OP_ACQUIRE", ctx, 1.0, 1.5,
                   attrs={"rows": 3})
    tr.record_span("batch.queue", ctx, 1.1, 1.2, status="denied")
    return tr


def test_chrome_export_matches_jax():
    random.seed(4)
    mine = _spans(tracing)
    random.seed(4)
    theirs = _spans(jtracing)
    assert mine.traces() == theirs.traces()
    assert mine.export_chrome() == theirs.export_chrome()
    assert mine.export_chrome_json(max_bytes=10**6) == \
        theirs.export_chrome_json(max_bytes=10**6)
    assert mine.export_chrome_json(max_bytes=10) == \
        theirs.export_chrome_json(max_bytes=10)
    assert mine.snapshot() == theirs.snapshot()
    mine.reset()
    assert mine.snapshot()["traces_buffered"] == 0


def test_device_trace_holds_drl_ranges(tmp_path):
    """A CPU store's dispatches inside start/stop_device_trace: the trace
    holds each as a ``drl/<command>`` range; an ``annotate=False`` span
    and the dispatches after the stop are not in it."""
    store = DeviceBucketStore(device="cpu", n_slots=4096,
                              clock=ManualClock(START))
    assert store.profiler.nvtx is False  # NVTX on a CUDA store only

    async def main():
        tracing.start_device_trace(str(tmp_path))
        try:
            with pytest.raises(RuntimeError):
                tracing.start_device_trace(str(tmp_path))
            keys = [f"k{i}" for i in range(3000)]
            await asyncio.wait_for(store.acquire_many(
                keys, [1] * len(keys), 10.0, 1.0), LIMIT_S)
            await asyncio.wait_for(asyncio.gather(*(
                store.acquire(f"s{i % 3}", 1, 5.0, 1.0) for i in range(20))),
                LIMIT_S)
            with store.profiler.span("wire_roundtrip", 1, annotate=False):
                pass
        finally:
            path = tracing.stop_device_trace()
        await asyncio.wait_for(store.acquire("after", 1, 5.0, 1.0), LIMIT_S)
        await store.aclose()
        return path

    path = asyncio.run(main())
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("name", "").startswith("drl/")]
    assert "drl/acquire_many" in names
    assert "drl/acquire_batch_grouped" in names or "drl/acquire_batch" in names
    assert "drl/wire_roundtrip" not in names
    assert tracing._DEVICE_TRACE is None
    # Outside a trace (no session, no ambient trace) a span is the shared
    # no-op again.
    assert store.profiler.span("x") is tracing._NULL_SPAN
    with pytest.raises(RuntimeError):
        tracing.stop_device_trace()


# -- the server ---------------------------------------------------------------

def _trace_ops(seed: int, n: int = 300):
    """A seeded request trace over every lane the plane feeds."""
    rng = np.random.default_rng(seed)
    keys = _zipf_keys(seed, n, n_keys=50)
    ops = []
    for i, k in enumerate(keys):
        r = rng.random()
        if r < 0.55:
            ops.append(("acquire", k, int(rng.integers(1, 3))))
        elif r < 0.65:
            ops.append(("window", k, 1))
        elif r < 0.72:
            ops.append(("sema", k, 1))
        elif r < 0.80:
            ops.append(("hier", k, int(rng.integers(1, 4))))
        elif r < 0.88:
            ops.append(("bulk", [f"b{j}" for j in rng.integers(0, 40, 32)],
                        1))
        elif r < 0.94:
            ops.append(("reserve", f"r{i}", int(rng.integers(1, 30))))
        else:
            ops.append(("stats", None, 0))
    return ops


async def _serve_trace(cli, ops):
    for op, k, c in ops:
        if op == "acquire":
            await cli.acquire(k, c, 20.0, 1.0)
        elif op == "window":
            await cli.window_acquire(k, c, 10.0, 1.0)
        elif op == "sema":
            await cli.concurrency_acquire(k, c, 3)
        elif op == "hier":
            await cli.acquire_hierarchical("tenant", k, c, 500.0, 5.0,
                                           30.0, 1.0)
        elif op == "bulk":
            await cli.acquire_many(k, [1] * len(k), 5.0, 1.0)
        elif op == "reserve":
            res = await cli.reserve(k, "tenant", "rkey", float(c), 400.0,
                                    4.0, 60.0, 2.0)
            if res.granted:
                await cli.settle(k, "tenant", float(c) * 1.5)
        else:
            await cli.stats()


def _counter_values(text: str) -> dict:
    types_, samples = pm.parse_openmetrics(text)
    out = {}
    for name, labels, value in samples:
        fam = name[:-len("_total")] if name.endswith("_total") else name
        if types_.get(fam) == "counter" or fam.startswith("drl_hot_key"):
            out[(name, labels)] = value
    return out


@pytest.mark.parametrize("backing", ["inprocess", "device", "fp"])
def test_served_trace_metrics_match_jax(backing):
    """The served counters on one trace. ``fp``: both packages' fingerprint
    stores, whose store families render too (those that depend on launch
    widths aside: the port pads to its rows, JAX to max_batch)."""
    ops = _trace_ops(11)

    def port_store():
        if backing == "inprocess":
            return InProcessBucketStore(clock=ManualClock(START))
        if backing == "fp":
            return FingerprintBucketStore(device="cpu", n_slots=4096,
                                          clock=ManualClock(START))
        return DeviceBucketStore(device="cpu", n_slots=4096,
                                 clock=ManualClock(START))

    def jax_store():
        if backing == "fp":
            from distributedratelimiting.redis_tpu.runtime.fp_store import (
                FingerprintBucketStore as JFp,
            )

            return JFp(n_slots=4096, clock=JClock(START))
        return JInProcess(clock=JClock(START))

    async def run(srv, Remote):
        await srv.start()
        cli = Remote(address=(srv.host, srv.port), coalesce_requests=False)
        try:
            await asyncio.wait_for(_serve_trace(cli, ops), 120)
            return await asyncio.wait_for(cli.metrics(), LIMIT_S)
        finally:
            await cli.aclose()
            await srv.aclose()

    mine = asyncio.run(run(BucketStoreServer(port_store(), audit=False),
                           RemoteBucketStore))
    theirs = asyncio.run(run(JServer(jax_store(), audit=False), JRemote))
    got, want = _counter_values(mine), _counter_values(theirs)
    # Flush frames are a card store's own (JAX's serial store has no
    # flushes to record).
    common = {k for k in set(got) & set(want)
              if not k[0].startswith("drl_flight_")
              and (not k[0].startswith("drl_store_")
                   or k[0].startswith(("drl_store_pregrows",
                                       "drl_store_fp_unresolved",
                                       "drl_store_sweeps",
                                       "drl_store_slots_evicted")))}
    names = {n for n, _ in common}
    for required in ("drl_requests_served_total",
                     "drl_connections_served_total",
                     "drl_admitted_tokens_total", "drl_hot_keys_offered",
                     "drl_hot_key_count", "drl_reservation_reserves_total",
                     "drl_reservation_settles_total",
                     "drl_retry_attempts_seen_total",
                     "drl_goodput_requests_doomed_total",
                     "drl_stats_resets_total"):
        assert required in names, required
    assert {k: got[k] for k in common} == {k: want[k] for k in common}
    # The port renders no family the JAX server does not (its store and
    # flush-frame counters aside: JAX's serial store has no launches).
    jax_families = set(pm.parse_openmetrics(theirs)[0])
    mine_families = set(pm.parse_openmetrics(mine)[0])
    extra = {f for f in mine_families - jax_families
             if not f.startswith(("drl_store_", "drl_flight_"))}
    assert extra == set()
    # The families JAX renders and the port leaves out — never rendered as
    # zeros: the Pallas sweep's failures (the port has no Pallas sweep) and
    # the flight families of this trace. Federation renders as JAX's.
    left_out = {f for f in jax_families - mine_families}
    assert left_out <= {
        "drl_store_pallas_sweep_failures", "drl_flight_frames",
        "drl_flight_frames_recorded", "drl_flight_dumps_written",
        "drl_flight_dumps_suppressed"}, left_out
    assert "drl_federation_slice_share" in mine_families


class _Mono:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.mark.parametrize("backing", ["inprocess", "device"])
def test_federation_families_render_as_jax(backing):
    """A home with an active ledger (leases, renews, a reclaim, an expiry
    and its heal on a manual monotonic clock) and a region agent attached
    to the server render JAX's ``drl_federation_*``,
    ``drl_federation_slice_share`` and ``drl_federation_region_*`` families:
    the same HELP and TYPE lines and the same samples."""
    from distributedratelimiting.redis_tpu.runtime.federation import (
        RegionFederation as JRegion,
    )
    from distributedratelimiting.redis_tpu_torch.runtime.federation import (
        RegionFederation,
    )

    def port_store():
        if backing == "inprocess":
            return InProcessBucketStore(clock=ManualClock(START))
        return DeviceBucketStore(device="cpu", n_slots=1024,
                                 clock=ManualClock(START))

    async def run(store, Server, Remote, Region):
        mono = _Mono()
        store.federation_ledger(clock=mono, default_ttl_s=6.0)
        srv = Server(store, audit=False)
        await srv.start()
        cli = Remote(address=(srv.host, srv.port), coalesce_requests=False)
        try:
            for i, region in enumerate(("r0", "r1", "r2")):
                for t, cap in (("g:a", 600.0), ("g:b", 900.0)):
                    await cli.fed_lease({
                        "region": region, "lease_id": f"{region}{t}",
                        "tenant": t, "demand": 1.0 + i,
                        "global_cap": cap, "global_rate": 2.0})
            mono.t = 2.0
            await cli.fed_renew({"region": "r0", "lease_id": "r0g:a",
                                 "tenant": "g:a", "total": 30.0,
                                 "demand": 9.0})
            await cli.fed_reclaim({"region": "r1", "lease_id": "r1g:b",
                                   "tenant": "g:b", "total": 12.0})
            mono.t = 7.0   # every lease but r0's renewed one expires
            await cli.fed_renew({"region": "r2", "lease_id": "r2g:a",
                                 "tenant": "g:a", "total": 5.0,
                                 "demand": 1.0})
            srv.federation_agent = Region(
                "rX", cli, tenants={"g:a": (600.0, 2.0)}, ttl_s=6.0,
                clock=_Mono())
            return await asyncio.wait_for(cli.metrics(), LIMIT_S)
        finally:
            await cli.aclose()
            await srv.aclose()

    mine = asyncio.run(run(port_store(), BucketStoreServer,
                           RemoteBucketStore, RegionFederation))
    theirs = asyncio.run(run(JInProcess(clock=JClock(START)), JServer,
                             JRemote, JRegion))

    def fed_lines(text):
        return [ln for ln in text.splitlines() if "drl_federation" in ln]

    got, want = fed_lines(mine), fed_lines(theirs)
    assert got == want
    names = set(pm.parse_openmetrics(mine)[0])
    for fam in ("drl_federation_leases_granted", "drl_federation_heals",
                "drl_federation_slice_share",
                "drl_federation_region_renews"):
        assert fam in names, fam
    assert 'drl_federation_slice_share{tenant="g:a",region="r0"}' in mine


def test_jax_client_reads_the_port_servers_plane(tmp_path):
    """OP_METRICS, OP_TRACES and OP_AUDIT from the JAX client; the traced
    requests' ``server.*`` spans carry the client's trace ids; the HTTP
    routes answer."""
    jtracing.configure(enabled=True, sample_rate=1.0, keep_rate=1.0)
    tracing.configure(enabled=True, sample_rate=1.0, keep_rate=1.0)
    jtracing.get_tracer().reset()
    tracing.get_tracer().reset()

    async def http(srv, path, accept=""):
        reader, writer = await asyncio.open_connection(srv.host,
                                                       srv.metrics_port)
        hdr = f"Accept: {accept}\r\n" if accept else ""
        writer.write(f"GET {path} HTTP/1.1\r\n{hdr}\r\n".encode())
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), LIMIT_S)
        writer.close()
        head, _, body = data.partition(b"\r\n\r\n")
        return head.decode(), body

    async def main():
        srv = BucketStoreServer(DeviceBucketStore(device="cpu", n_slots=1024),
                                metrics_port=0, flight_dir=str(tmp_path))
        await srv.start()
        cli = JRemote(address=(srv.host, srv.port), coalesce_requests=False)
        try:
            for i in range(12):
                await asyncio.wait_for(cli.acquire(f"k{i % 3}", 1, 5.0, 1.0),
                                       LIMIT_S)
            text = await asyncio.wait_for(cli.metrics(), LIMIT_S)
            chrome = await asyncio.wait_for(cli.traces(), LIMIT_S)
            audit = await asyncio.wait_for(cli.audit(), LIMIT_S)
            om_head, om = await http(srv, "/metrics",
                                     "application/openmetrics-text")
            plain_head, plain = await http(srv, "/metrics")
            _, flight = await http(srv, "/flight")
            _, traces = await http(srv, "/traces?drain=1")
            missing, _ = await http(srv, "/nope")
            drained = await asyncio.wait_for(cli.traces(), LIMIT_S)
        finally:
            await cli.aclose()
            await srv.aclose()
        return (srv, text, chrome, audit, om_head, om, plain_head, plain,
                flight, traces, missing, drained)

    try:
        (srv, text, chrome, audit, om_head, om, plain_head, plain, flight,
         traces, missing, drained) = asyncio.run(main())
        client_ids = {t["trace_id"] for t in jtracing.get_tracer().traces()}
    finally:
        jtracing.configure(enabled=False)
        tracing.configure(enabled=False)
        jtracing.get_tracer().reset()
        tracing.get_tracer().reset()
    types_, samples = jm.parse_openmetrics(text)
    served = [v for n, _, v in samples if n == "drl_requests_served_total"]
    assert served == [12.0]  # the twelve acquires (the scrape counts after)
    assert types_["drl_serving_latency_seconds"] == "histogram"
    spans = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    server_ids = {e["args"]["trace_id"] for e in spans
                  if e["name"].startswith("server.")}
    assert server_ids and server_ids <= client_ids
    # The twelve acquires and the OP_METRICS scrape, each its own trace.
    assert len({e["args"]["trace_id"] for e in spans
                if e["name"] == "server.acquire"}) == 12
    assert len(server_ids) == 13
    assert audit["enabled"] and audit["breaches"] == 0
    assert "application/openmetrics-text" in om_head and b"# {" in om
    assert "version=0.0.4" in plain_head and b"# {" not in plain
    assert om.endswith(b"# EOF\n") and plain.endswith(b"# EOF\n")
    dumped = json.loads(flight)
    assert dumped["suppressed"] is False
    assert os.path.dirname(dumped["dumped"]) == str(tmp_path)
    assert {e["args"]["trace_id"] for e in json.loads(traces)["traceEvents"]
            if e["ph"] == "X"} >= server_ids
    assert [e for e in drained["traceEvents"] if e["ph"] == "X"
            and e["name"] == "server.acquire"] == []
    assert "404" in missing


def test_flush_failure_dumps_once(tmp_path):
    """One flush failure injected at the port's ``store.flush`` seam: its
    requests get the error, and exactly one ``flush_error`` dump lands —
    parseable JSONL whose frames hold the flushes, the failed one with its
    error."""

    async def main():
        srv = BucketStoreServer(DeviceBucketStore(device="cpu", n_slots=1024),
                                flight_dir=str(tmp_path), audit=False)
        await srv.start()
        cli = RemoteBucketStore(address=(srv.host, srv.port),
                                coalesce_requests=False)
        try:
            for i in range(5):
                await asyncio.wait_for(cli.acquire(f"w{i}", 1, 5.0, 1.0),
                                       LIMIT_S)
            faults.install(faults.FaultInjector(1, {"store.flush": (
                faults.FaultRule(kind="error", probability=1.0,
                                 max_faults=1),)}))
            try:
                outs = await asyncio.wait_for(asyncio.gather(
                    *(cli.acquire(f"x{i}", 1, 5.0, 1.0) for i in range(8)),
                    return_exceptions=True), LIMIT_S)
                for i in range(3):  # later flushes are healthy again
                    await asyncio.wait_for(cli.acquire(f"y{i}", 1, 5.0, 1.0),
                                           LIMIT_S)
            finally:
                faults.uninstall()
            stats = await asyncio.wait_for(cli.stats(), LIMIT_S)
        finally:
            await cli.aclose()
            await srv.aclose()
        return outs, stats

    outs, stats = asyncio.run(main())
    errors = [o for o in outs if isinstance(o, BaseException)]
    assert errors and all("injected fault (store.flush#"
                          in str(e) for e in errors)
    dumps = [f for f in os.listdir(tmp_path) if f.endswith(".jsonl")]
    assert len(dumps) == 1 and "flush_error" in dumps[0]
    with open(tmp_path / dumps[0]) as f:
        header, *frames = [json.loads(line) for line in f]
    assert header["reason"] == "flush_error"
    assert "store.flush" in header["error"]
    flushes = [fr for fr in frames if fr["kind"] == "flush"]
    assert len(flushes) >= 6
    assert [fr for fr in flushes if fr["error"]][0]["n"] == len(errors)
    assert stats["flight_recorder"]["dumps_written"] == 1
    assert stats["flight_recorder"]["frames_recorded"] >= len(flushes) + 3


class _NativeCounters:
    """Equal counters for both packages' native front-ends (the families'
    renderer reads nothing else of them)."""

    n_shards = 2
    uring_shards = 1

    def __init__(self, hist_cls):
        self._hist_cls = hist_cls

    def counts(self):
        return (1234, 17, 321)

    def _hist(self, n):
        h = self._hist_cls()
        h.counts = [0] * h.N_BUCKETS
        h.counts[20], h.counts[30] = n, 2 * n
        h.total, h.sum_s = 3 * n, 0.125 * n
        return h

    def latency_histogram(self):
        return self._hist(5)

    def stage_histograms(self):
        return {"native_queue": self._hist(3), "native_exec": self._hist(4)}

    def tier0_stats(self):
        return {"hits": 900, "local_denies": 40, "misses": 60,
                "hit_rate": 0.94, "installs": 12, "evictions": 1,
                "entries": 11, "carry_keys": 0, "syncs": 55,
                "sync_failures": 2, "keys_synced": 300,
                "overadmit_total": 1.5, "overadmit_max": 1.0,
                "retired_config_rows": 0, "last_sync_age_s": 0.25,
                "grant_tokens": 950.0}

    def bulk_stats(self):
        return {"frames": 9, "frames_local": 4, "rows": 4096,
                "rows_local": 3000, "rows_residue": 1096,
                "permits_local": 3000, "hot_ring_dropped": 0}


def _native_lines(text: str) -> list:
    keep = ("drl_connections_served", "drl_requests_served",
            "drl_batches_flushed", "drl_native_", "drl_tier0_",
            "drl_serving_latency_seconds")
    out = []
    for line in text.splitlines():
        parts = line.split()
        name = (parts[2] if len(parts) > 2 else "") if line.startswith(
            "#") else line
        if name.startswith(keep) or 'stage="native_' in line:
            out.append(line)
    return out


def test_native_families_render_as_jax_does():
    """With equal native counters, the port's registry renders the native
    front-end's, tier-0's and the bulk lane's families — and the native
    serving and stage histograms — byte for byte as the JAX server's."""
    from distributedratelimiting.redis_tpu.utils.metrics import (
        LatencyHistogram as JHist,
    )
    from distributedratelimiting.redis_tpu_torch.utils.metrics import (
        LatencyHistogram as PHist,
    )

    port = BucketStoreServer(DeviceBucketStore(device="cpu", n_slots=256),
                             audit=False)
    jax = JServer(JInProcess(), audit=False)
    port._native, jax._native = _NativeCounters(PHist), _NativeCounters(JHist)
    try:
        mine = _native_lines(port.registry.render())
        theirs = _native_lines(jax.registry.render())
    finally:
        port._native = jax._native = None
    assert mine == theirs
    text = "\n".join(mine)
    for family in ("drl_batches_flushed_total 321", "drl_native_frontend 1",
                   "drl_native_fe_shards 2", "drl_native_fe_uring_shards 1",
                   "drl_tier0_hits_total 900",
                   "drl_native_bulk_rows_local_total 3000",
                   'stage="native_exec"'):
        assert family in text, family
