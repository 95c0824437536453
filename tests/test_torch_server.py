"""The port's store server and client against the JAX package's.

One seeded trace — concurrent scalar acquires through a coalescing client
(``ACQUIRE_MANY`` frames) and a per-request one (``OP_ACQUIRE``), a bulk
``acquire_many`` split into chained frames with a duplicate key on both
sides of a chunk boundary, peeks, counter syncs, the cap-5 × 32 case and a
ManualClock advanced between rounds — runs through all four pairings: port
client → port server, JAX client → JAX server, JAX client → port server,
port client → JAX server. Time belongs to the server's store
(``DeviceBucketStore(device="cpu")`` or the JAX one, each on a
ManualClock). Tolerance: grants, peeks and granted rows' remaining are
exact (per key for concurrent asks: independent frames may decide in either
order); counter-sync replies within two ulps of the larger value (the rule
of the counter tests: XLA on the CPU may fuse a multiply-add); the bulk
call's remaining within atol 1e-4 (float order of a repeated key's
consumption, as in ``tests/test_torch_store.py``). A denied row's remaining
is not compared: it depends on how a burst's requests split into flushes,
which timing decides in either package.

Also: HELLO auth, the version gate, deadline shedding, the not-served
answer of unported ops (never "unknown op", which the JAX client would take
for an old peer), ``OP_SAVE`` files restored across packages, the key-blob
lane through the store, the periodic sweeper, the limiters over a remote
store, client timeouts and dial failures, the console entry point, and the
new modules' independence from JAX.
"""

import asyncio
import json
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.runtime import checkpoint as jcp
from distributedratelimiting.redis_tpu.runtime import wire as jw
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
    DeviceBucketStore as JStore,
)
from distributedratelimiting.redis_tpu_torch import (
    ApproximateTokenBucketOptions,
    ApproximateTokenBucketRateLimiter,
    BucketStoreServer,
    DeviceBucketStore,
    ManualClock,
    PartitionedRateLimiter,
    RemoteBucketStore,
    StoreTimeoutError,
    TokenBucketOptions,
    TokenBucketRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.runtime import checkpoint as pcp
from distributedratelimiting.redis_tpu_torch.runtime import server as pserver
from distributedratelimiting.redis_tpu_torch.runtime import wire as pw

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = 1_000_000
#: A hang fails fast instead of eating the suite's time limit.
LIMIT_S = 20.0


def w(coro, limit=LIMIT_S):
    return asyncio.wait_for(coro, limit)


class _Server:
    """One store server of either package on the running loop, with its
    ManualClock (the time authority)."""

    def __init__(self, kind: str, **kw) -> None:
        self.kind = kind
        if kind == "port":
            self.clock = ManualClock(START)
            self.store = DeviceBucketStore(device="cpu", clock=self.clock,
                                           n_slots=256)
            self.server = BucketStoreServer(self.store, **kw)
        else:
            self.clock = JClock(START)
            self.store = JStore(clock=self.clock, n_slots=256)
            self.server = JServer(self.store, observability=False,
                                  audit=False, **kw)

    async def __aenter__(self):
        await self.server.start()
        return self

    async def __aexit__(self, *exc):
        await self.server.aclose()
        await self.store.aclose()

    @property
    def address(self):
        return (self.server.host, self.server.port)


def _client(kind, address, **kw):
    cls = RemoteBucketStore if kind == "port" else JRemote
    return cls(address=address, **kw)


def _ulps2(a, b) -> bool:
    a, b = np.float32(a), np.float32(b)
    return abs(float(a) - float(b)) <= 2 * float(
        np.spacing(max(abs(a), abs(b))))


async def _trace(srv, client_kind, seed):
    """The seeded trace; returns everything the clients observed."""
    rng = np.random.default_rng(seed)
    co = _client(client_kind, srv.address)
    solo = _client(client_kind, srv.address, coalesce_requests=False)
    cap, rate = 10.0, 2.0
    hot = [f"hot{i}" for i in range(8)]
    # Each key asks a fixed count, so a burst decides the same whatever
    # flushes its requests fall into.
    per_key = {k: int(c) for k, c in zip(hot, rng.integers(1, 4, len(hot)))}
    out = {"scalar": [], "peek": [], "sync": []}
    try:
        for _round in range(4):
            for cli in (solo, co):
                keys = [hot[i] for i in (rng.zipf(1.4, 40) - 1) % len(hot)]
                res = await w(asyncio.gather(*(
                    cli.acquire(k, per_key[k], cap, rate) for k in keys)))
                # Per key, the sorted outcomes: concurrent frames (a
                # coalescing client's independent flushes) may decide in
                # either order, so which ask of a key won is not fixed.
                by_key = {}
                for k, r in zip(keys, res):
                    by_key.setdefault(k, []).append(
                        (r.granted, r.remaining if r.granted else -1.0))
                out["scalar"].append({k: sorted(v)
                                      for k, v in by_key.items()})
            out["peek"].append(await w(asyncio.gather(*(
                asyncio.to_thread(solo.peek_blocking, k, cap, rate)
                for k in hot[:4]))))
            for k, c in (("s0", 3.5), ("s1", 1.0), ("s0", 0.25)):
                r = await w(solo.sync_counter(k, c, 4.0))
                out["sync"].append((r.global_score, r.period_ewma_ticks))
            srv.clock.advance_seconds(0.7)
        # Cap-5 × 32 one-permit asks → exactly 5, on both lanes.
        for cli, key in ((solo, "five-a"), (co, "five-b")):
            res = await w(asyncio.gather(*(cli.acquire(key, 1, 5.0, 1.0)
                                           for _ in range(32))))
            out[key] = sum(r.granted for r in res)
            assert out[key] == 5
        # A bulk call chunked into chained frames; "dup" (cap 3) asks 1 in
        # the first chunk and 3 in the last: in chunk order the first
        # grants and the second is denied — reversed, the other way round.
        keys = ["dup"] + [f"b{i}" for i in rng.integers(0, 30, 58)] + ["dup"]
        counts = [1] + rng.integers(0, 3, 58).tolist() + [3]
        res = await w(co.acquire_many(keys, counts, 3.0, 1.0))
        out["bulk"] = (res.granted.tolist(), res.remaining.copy())
        assert res.granted[0] and not res.granted[-1]
        res = await w(solo.acquire_many(keys[::-1], counts[::-1], 3.0, 1.0,
                                        with_remaining=False))
        out["bulk_verdicts"] = res.granted.tolist()
    finally:
        await co.aclose()
        await solo.aclose()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_four_pairings_agree_on_a_seeded_trace(monkeypatch, seed):
    # Small chunks, so one bulk call crosses several chained frames.
    monkeypatch.setattr(pw, "BULK_CHUNK_BUDGET", 96)
    monkeypatch.setattr(jw, "BULK_CHUNK_BUDGET", 96)
    assert len(pw.bulk_chunk_spans(np.full(60, 3))) > 3

    async def run(server_kind, client_kind):
        async with _Server(server_kind) as srv:
            return await _trace(srv, client_kind, seed)

    results = {(s, c): asyncio.run(run(s, c))
               for s in ("port", "jax") for c in ("port", "jax")}
    ref = results[("jax", "jax")]
    for pair, got in results.items():
        assert got["scalar"] == ref["scalar"], pair
        assert got["peek"] == ref["peek"], pair
        assert got["five-a"] == ref["five-a"], pair
        assert got["five-b"] == ref["five-b"], pair
        assert got["bulk"][0] == ref["bulk"][0], pair
        np.testing.assert_allclose(got["bulk"][1], ref["bulk"][1], atol=1e-4)
        assert got["bulk_verdicts"] == ref["bulk_verdicts"], pair
        for (s, p), (s0, p0) in zip(got["sync"], ref["sync"]):
            assert _ulps2(s, s0) and _ulps2(p, p0), pair


async def _raw(address, *frames):
    """Send raw frames on one connection; replies by seq, and whether the
    server closed the connection after them."""
    reader, writer = await asyncio.open_connection(*address)
    for f in frames:
        writer.write(f)
    await writer.drain()
    replies = {}
    closed = False
    for _ in frames:
        body = await w(pw.read_frame(reader), 5)
        if body is None:
            closed = True
            break
        seq, kind, vals = pw.decode_response(body)
        replies[seq] = (kind, vals)
    if not closed:
        try:
            closed = await asyncio.wait_for(pw.read_frame(reader),
                                            0.2) is None
        except asyncio.TimeoutError:
            closed = False
    writer.close()
    return replies, closed


def test_hello_auth_passes_and_fails():
    async def main():
        async with _Server("port", auth_token="s3cret") as srv:
            for cls in (RemoteBucketStore, JRemote):
                ok = cls(address=srv.address, auth_token="s3cret")
                assert (await w(ok.acquire("k", 1, 5.0, 1.0))).granted
                await ok.aclose()
                bad = cls(address=srv.address, auth_token="wrong",
                          retry_policy=None)
                with pytest.raises(Exception, match="authentication failed"):
                    await w(bad.ping())
                await bad.aclose()
            replies, closed = await _raw(
                srv.address, pw.encode_request(7, pw.OP_PING))
            assert replies[7][0] == pw.RESP_ERROR
            assert "authentication required" in replies[7][1][0] and closed
            replies, closed = await _raw(
                srv.address, pw.encode_request(1, pw.OP_HELLO, "s3cret"),
                pw.encode_request(2, pw.OP_PING))
            assert replies == {1: (pw.RESP_EMPTY, ()), 2: (pw.RESP_EMPTY, ())}
            assert not closed

    asyncio.run(main())


def test_trace_tails_parent_server_spans_on_the_client_trace():
    """A JAX client's trace tails (scalar op flag, bulk flags bit 4) reach
    the port's server: it serves the stripped frames and records its
    ``server.<op>`` spans under the client's trace and span ids."""
    from distributedratelimiting.redis_tpu.utils import tracing as jtr
    from distributedratelimiting.redis_tpu_torch.utils import tracing as ptr

    async def main():
        async with _Server("port", tracing_config={
                "enabled": True, "sample_rate": 1.0,
                "keep_rate": 1.0}) as srv:
            cli = JRemote(address=srv.address, coalesce_requests=False)
            assert (await w(cli.acquire("t", 1, 5.0, 1.0))).granted
            res = await w(cli.acquire_many(["a", "b"], [1, 9], 5.0, 1.0))
            assert res.granted.tolist() == [True, False]
            await cli.aclose()

    jtr.configure(enabled=True, sample_rate=1.0, keep_rate=1.0)
    try:
        asyncio.run(main())
        client = {(sp["trace_hi"], sp["trace_lo"], sp["span_id"]): sp["name"]
                  for t in jtr.get_tracer().traces(drain=True)
                  for sp in t["spans"]}
        server = [sp for t in ptr.get_tracer().traces(drain=True)
                  for sp in t["spans"] if sp["name"].startswith("server.")]
    finally:
        jtr.configure(enabled=False, keep_rate=0.1)
        ptr.configure(enabled=False, keep_rate=0.1)
    by_name = {sp["name"]: sp for sp in server}
    assert set(by_name) == {"server.acquire", "server.acquire_many"}
    assert by_name["server.acquire_many"]["status"] == "denied"
    for name, sp in by_name.items():
        parent = client[(sp["trace_hi"], sp["trace_lo"], sp["parent_id"])]
        assert parent == "client." + name.split(".", 1)[1]


def test_version_mismatch_answers_and_drops():
    async def main():
        async with _Server("port") as srv:
            frame = bytearray(pw.encode_request(9, pw.OP_PING))
            frame[4] = 3
            replies, closed = await _raw(srv.address, bytes(frame))
            assert replies[9][0] == pw.RESP_ERROR
            assert "protocol version mismatch" in replies[9][1][0]
            assert closed

    asyncio.run(main())


def test_deadline_shed_leaves_the_store_untouched():
    async def main():
        async with _Server("port") as srv:
            frames = [pw.encode_request(1, pw.OP_ACQUIRE, "d", 4, 5.0, 1.0,
                                        deadline_s=-1.0),
                      pw.encode_bulk_request(2, [b"d"], [4], 5.0, 1.0,
                                             deadline_s=-1.0, attempt=1),
                      pw.encode_request(3, pw.OP_ACQUIRE, "d", 1, 5.0, 1.0,
                                        deadline_s=30.0, attempt=2)]
            replies, _ = await _raw(srv.address, *frames)
            for seq in (1, 2):
                assert replies[seq][0] == pw.RESP_ERROR
                assert "deadline exceeded" in replies[seq][1][0]
            assert replies[3] == (pw.RESP_DECISION, (True, 4.0))
            assert srv.server.requests_shed == 2
            assert srv.server.retry_attempts_seen == 2
            stats = await w(_stats(srv.address))
            assert stats["requests_shed"] == 2
            assert stats["retry"]["attempts_seen"] == 2

    asyncio.run(main())


async def _stats(address):
    cli = RemoteBucketStore(address=address)
    try:
        return await cli.stats()
    finally:
        await cli.aclose()


def test_unported_ops_answer_without_the_old_peer_words():
    async def main():
        async with _Server("port") as srv:
            # OP_SEMA, OP_ACQUIRE_H and every bulk kind (the hierarchical
            # one too) are served since the semaphores and the two-level
            # admission were ported.
            assert not pserver._UNPORTED_BULK_KINDS
            assert not {pw.OP_SEMA, pw.OP_ACQUIRE_H} & pserver._UNPORTED_OPS
            # Since live config: only federation remains; the four
            # placement ops and OP_CONFIG (a fetch, an abort, an unknown
            # form, a stale prepare) answer as a JAX server does.
            assert pserver._UNPORTED_OPS == {
                pw.OP_FED_LEASE, pw.OP_FED_RENEW, pw.OP_FED_RECLAIM}
            placement_frames = [pw.encode_request(
                300 + i, op, "{}", 1, 5.0, 1.0) for i, op in enumerate(
                    (pw.OP_PLACEMENT, pw.OP_PLACEMENT_ANNOUNCE,
                     pw.OP_MIGRATE_PULL, pw.OP_MIGRATE_PUSH, pw.OP_CONFIG))]
            placement_frames += [pw.encode_request(
                310 + i, pw.OP_CONFIG, json.dumps(body), 1, 5.0, 1.0)
                for i, body in enumerate((
                    {"abort": 3}, {"bogus": 1},
                    {"prepare": {"kind": "bucket", "old": [5.0, 1.0],
                                 "new": [4.0, 1.0]}, "version": 0}))]
            got, closed = await _raw(srv.address, *placement_frames)
            assert not closed
            async with _Server("jax") as jsrv:
                want, _ = await _raw(jsrv.address, *placement_frames)
            assert got == want
            assert all("not served" not in str(v) for v in got.values())
            frames = []
            for op in sorted(pserver._UNPORTED_OPS):
                frames.append(pw.encode_request(
                    op, op, "{}" if op in pw.TEXT_OPS else "k", 1, 5.0, 1.0))
            frames.append(pw.encode_request(200, pw.OP_FED_LEASE, "{}", 1,
                                            5.0, 1.0, trace=(1, 2, 3, 1)))
            frames.append(bytes([6, 0, 0, 0, 4, 99, 0, 0, 0, 30]))  # no such op
            replies, closed = await _raw(srv.address, *frames)
            assert not closed
            for seq, (kind, vals) in replies.items():
                assert kind == pw.RESP_ERROR, seq
                if seq == 99:
                    assert vals[0] == "RemoteStoreError('unknown op 30')"
                    continue
                assert "not served by this server" in vals[0], (seq, vals)
                assert "unknown op" not in vals[0]
                assert "unknown bulk kind" not in vals[0]
            assert len(replies) == len(frames)
            # The JAX client's reservation lane, hierarchical and
            # semaphore calls are served: no silent fallback, no latch
            # (two-level, not the flat fallback).
            assert not {pw.OP_RESERVE, pw.OP_SETTLE} & pserver._UNPORTED_OPS
            cli = JRemote(address=srv.address)
            res = await w(cli.reserve("r1", "t", "k", 2.0, 9.0, 1.0, 5.0,
                                      1.0))
            assert res.granted and not res.fallback and res.reserved == 2.0
            assert (await w(cli.acquire_hierarchical(
                "t", "hk", 1, 9.0, 1.0, 5.0, 1.0))).granted
            res = await w(cli.acquire_hierarchical_many(
                ["t"], ["hk"], [1], 9.0, 1.0, 5.0, 1.0))
            assert res.granted.tolist() == [True]
            assert tuple(await w(cli.concurrency_acquire("k", 1, 5))) == (
                True, 1.0)
            stats = cli.resilience_stats()
            assert stats["hier_fallbacks"] == stats["reserve_fallbacks"] == 0
            assert cli._peer_traces and cli._peer_hier
            await cli.aclose()
            # The unported ops never touched the store; the tenant's bucket
            # took the reserve's 2 and the two granted costs, the keys'
            # theirs.
            assert srv.store.peek_blocking("k", 5.0, 1.0) == 3.0
            assert srv.store.peek_blocking("hk", 5.0, 1.0) == 3.0
            assert srv.store.peek_blocking("t", 9.0, 1.0) == 5.0

    asyncio.run(main())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_op_save_restores_into_the_other_package(tmp_path, writer):
    path = str(tmp_path / "snap.pkl")

    async def main():
        async with _Server(writer, snapshot_path=path) as srv:
            cli = _client(writer, srv.address)
            await w(cli.acquire_many([f"k{i}" for i in range(20)],
                                     list(range(20)), 30.0, 1.0))
            await w(cli.sync_counter("ctr", 7.0, 1.0))
            await w(cli.save())
            await cli.aclose()
            return [srv.store.peek_blocking(f"k{i}", 30.0, 1.0)
                    for i in range(20)]

    want = asyncio.run(main())
    if writer == "port":
        clock = JClock(START)
        store = JStore(clock=clock)
        jcp.load_snapshot(store, path)
    else:
        clock = ManualClock(START)
        store = DeviceBucketStore(device="cpu", clock=clock)
        pcp.load_snapshot(store, path)
    assert [store.peek_blocking(f"k{i}", 30.0, 1.0)
            for i in range(20)] == want == [30.0 - i for i in range(20)]
    assert store.sync_counter_blocking("ctr", 0.0, 0.0).global_score == 7.0
    asyncio.run(store.aclose())


@pytest.mark.parametrize("client", ["port", "jax"])
def test_incremental_op_save_writes_a_base_then_deltas(tmp_path, client):
    """``snapshot_incremental``: OP_SAVE twice → one base and one delta;
    OP_STATS carries the chain's stats with the store's dirty/total, whose
    window is save to save (as the JAX server's)."""
    path = str(tmp_path / "snap.pkl")

    async def main():
        async with _Server("port", snapshot_path=path,
                           snapshot_incremental=True) as srv:
            cli = _client(client, srv.address)
            await w(cli.acquire_many([f"k{i}" for i in range(20)],
                                     [1] * 20, 30.0, 1.0))
            stats = await w(cli.stats())
            assert stats["snapshot_chain"]["dirty"] == {"dirty": 20,
                                                       "total": 256}
            await w(cli.save())
            stats = await w(cli.stats())
            assert stats["snapshot_chain"]["dirty"]["dirty"] == 0
            assert stats["snapshot_chain"]["full_saves"] == 1
            await w(cli.acquire_many(["k1", "k2", "new"], [2, 2, 2],
                                     30.0, 1.0))
            assert (await w(cli.stats()))["snapshot_chain"]["dirty"][
                "dirty"] == 3
            await w(cli.save())
            stats = await w(cli.stats())
            await cli.aclose()
            return stats, srv.store.snapshot()

    stats, snap = asyncio.run(main())
    chain = stats["snapshot_chain"]
    assert chain["chain_len"] == 1 and chain["delta_saves"] == 1
    assert 0 < chain["last_delta_bytes"] < chain["base_bytes"]
    assert sorted(os.listdir(tmp_path)) == ["snap.pkl", "snap.pkl.delta.1"]
    # Both packages restore the chain to the saving store's state.
    store = DeviceBucketStore(device="cpu", clock=ManualClock(START),
                              n_slots=256)
    assert pcp.load_snapshot_chain(store, path) == 1
    jstore = JStore(clock=JClock(START), n_slots=256)
    assert jcp.load_snapshot_chain(jstore, path) == 1
    for st in (store, jstore):
        assert [st.peek_blocking(k, 30.0, 1.0) for k in ("k0", "k1", "new")
                ] == [29.0, 27.0, 28.0]
    np.testing.assert_array_equal(
        store.snapshot()["tables"][(30.0, 1.0)]["tokens"],
        snap["tables"][(30.0, 1.0)]["tokens"])
    asyncio.run(store.aclose())


def test_a_full_save_server_reports_no_chain(tmp_path):
    async def main():
        async with _Server("port", snapshot_path=str(tmp_path / "s")) as srv:
            cli = _client("port", srv.address)
            await w(cli.save())
            stats = await w(cli.stats())
            await cli.aclose()
            assert all(t.dirty_slots is None
                       for t in srv.store._tables.values())
            return stats

    assert "snapshot_chain" not in asyncio.run(main())
    assert os.listdir(tmp_path) == ["s"]


#: Seconds a console child may take to print a line, to exit after
#: SIGTERM, or to die after a kill: every wait on a child is bounded.
CHILD_LINE_S = 120.0
CHILD_EXIT_S = 30.0


def _console(*args):
    """The console server as a child: its stdout read line by line on a
    thread of its own (so a read can time out), its stderr into a file (a
    pipe nobody reads can fill and stall the child)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "distributedratelimiting.redis_tpu_torch.runtime.server",
         "--port", "0", *args],
        stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=ROOT)
    proc.err_file = err
    proc.lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            proc.lines.put(line)
        proc.lines.put(None)  # EOF

    proc.pump = threading.Thread(target=pump, daemon=True)
    proc.pump.start()
    return proc


def _stderr(proc) -> str:
    proc.err_file.seek(0)
    return proc.err_file.read()


def _readline(proc) -> str:
    """The child's next stdout line ("" at EOF), waiting at most
    CHILD_LINE_S."""
    try:
        line = proc.lines.get(timeout=CHILD_LINE_S)
    except queue.Empty:
        raise AssertionError(
            f"no line from the console in {CHILD_LINE_S} s: "
            f"{_stderr(proc)[-2000:]}") from None
    return "" if line is None else line


def _console_address(proc):
    """The console server's address, and the lines it printed before its
    listening line (the restore's)."""
    before = []
    line = _readline(proc)
    while line.startswith(("restored", "WARNING", "starting")):
        before.append(line)
        line = _readline(proc)
    assert line.startswith("bucket-store server listening on "), (
        line, _stderr(proc) if proc.poll() is not None else "")
    host, port = line.rsplit(" ", 1)[1].strip().rsplit(":", 1)
    return before, (host, int(port))


def _rest(proc) -> str:
    """Everything the (exited) child printed after the lines read so far."""
    proc.pump.join(timeout=CHILD_EXIT_S)
    out = []
    while not proc.lines.empty():
        line = proc.lines.get_nowait()
        if line is not None:
            out.append(line)
    return "".join(out)


def _stop(proc) -> str:
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=CHILD_EXIT_S) == 0, _stderr(proc)
    return _rest(proc)


def _kill(proc) -> None:
    """The finally-clause cleanup: kill a child still running, and wait
    for it with a bound."""
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=CHILD_EXIT_S)
    proc.err_file.close()


@pytest.mark.parametrize("backend", ["inprocess", "device"])
def test_console_server_restarts_on_its_chain(tmp_path, backend):
    """``--snapshot-incremental``: two OP_SAVEs and SIGTERM's final save
    leave a base and two deltas; a restart applies them (``(+2 deltas)``)
    and serves the saved balances. ``--backend inprocess`` serves the serial
    store."""
    path = str(tmp_path / "snap.pkl")
    args = ["--backend", backend, "--snapshot-path", path,
            "--snapshot-incremental"]
    if backend == "device":
        args += ["--device", "cpu", "--slots", "1024"]

    async def first(addr):
        cli = JRemote(address=addr)
        await w(cli.ping())
        res = await w(asyncio.gather(*(cli.acquire("five", 1, 5.0, 1e-6)
                                       for _ in range(32))))
        assert sum(r.granted for r in res) == 5
        # A base large enough that a two-key delta stays under half its size
        # (a larger delta compacts into a new base).
        await w(cli.acquire_many([f"bulk{i}" for i in range(200)],
                                 [1] * 200, 10.0, 1e-6))
        await w(cli.save())
        await w(cli.acquire_many(["a", "b"], [3, 4], 10.0, 1e-6))
        await w(cli.save())
        stats = await w(cli.stats())
        await w(cli.acquire("c", 2, 10.0, 1e-6))  # saved by SIGTERM only
        await cli.aclose()
        return stats

    async def second(addr):
        cli = RemoteBucketStore(address=addr)
        out = [await w(asyncio.to_thread(cli.peek_blocking, k, cap, 1e-6))
               for k, cap in (("five", 5.0), ("a", 10.0), ("b", 10.0),
                              ("c", 10.0))]
        await cli.aclose()
        return out

    proc = _console(*args)
    try:
        _, addr = _console_address(proc)
        stats = asyncio.run(first(addr))
        assert stats["snapshot_chain"]["chain_len"] == 1
        assert "store" in stats or backend == "inprocess"
        if backend == "inprocess":
            assert stats["snapshot_chain"]["dirty"] == {"dirty": 0,
                                                        "total": 203}
        assert "final checkpoint" in _stop(proc)
    finally:
        _kill(proc)
    assert sorted(os.listdir(tmp_path)) == [
        "snap.pkl", "snap.pkl.delta.1", "snap.pkl.delta.2"]
    proc = _console(*args)
    try:
        before, addr = _console_address(proc)
        assert before == [f"restored snapshot from {path} (+2 deltas)\n"]
        assert asyncio.run(second(addr)) == [0.0, 7.0, 6.0, 8.0]
        _stop(proc)
    finally:
        _kill(proc)


def test_console_refuses_incremental_without_a_path():
    proc = _console("--snapshot-incremental", "--device", "cpu")
    try:
        assert proc.wait(timeout=60) == 2
        assert ("--snapshot-incremental requires --snapshot-path"
                in _stderr(proc))
    finally:
        _kill(proc)


def test_checkpoint_errors_are_typed(tmp_path):
    store = DeviceBucketStore(device="cpu", clock=ManualClock(START))
    path = str(tmp_path / "s.pkl")
    pcp.save_snapshot(store, path, placement_epoch=4)
    with pytest.raises(pcp.PlacementMismatchError):
        pcp.load_snapshot(store, path, expected_placement_epoch=5)
    pcp.load_snapshot(store, path, expected_placement_epoch=4)
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) // 2])
    with pytest.raises(pcp.SnapshotCorruptError):
        pcp.load_snapshot(store, path)
    delta = tmp_path / "s.pkl.delta.1"
    delta.write_bytes(b"x")
    pcp.save_snapshot(store, path)
    assert not delta.exists()  # a full save supersedes any delta chain


def test_key_blob_lane_through_the_store():
    """The store's bulk lane takes a KeyBlob as it takes a list — also when
    the table runs dry mid-call and a sweep makes the store resolve the
    same blob a second time — and decides as the JAX store does on the
    JAX KeyBlob."""
    keys = [f"k{i}" for i in range(24)] + ["k3", "k30"]
    blobs = [k.encode() for k in keys]
    frame = jw.encode_bulk_request(1, blobs, np.ones(len(keys)), 4.0, 1.0)
    views = {"port": pw.decode_bulk_request(frame[4:], as_view=True)[1],
             "jax": jw.decode_bulk_request(frame[4:], as_view=True)[1]}
    got = {}
    for kind, keyset in (("port", views["port"]), ("list", keys),
                         ("jax", views["jax"])):
        clock = (JClock if kind == "jax" else ManualClock)(START)
        store = (JStore(clock=clock, n_slots=16) if kind == "jax" else
                 DeviceBucketStore(device="cpu", clock=clock, n_slots=16))
        # 16 slots hold 16 stale buckets: the bulk call sweeps them.
        store.acquire_many_blocking([f"old{i}" for i in range(16)],
                                    [1] * 16, 4.0, 1.0)
        clock.advance_seconds(60)
        res = store.acquire_many_blocking(keyset, [1] * len(keys), 4.0, 1.0)
        got[kind] = (res.granted.tolist(), res.remaining.tolist(),
                     store.metrics.sweeps > 0)
        asyncio.run(store.aclose())
    assert got["port"] == got["list"] == got["jax"]
    assert got["port"][2]


def test_periodic_sweeper_evicts_and_stops_before_the_batchers():
    async def main():
        clock = ManualClock(START)
        store = DeviceBucketStore(device="cpu", clock=clock, n_slots=64)
        await store.acquire_many([f"k{i}" for i in range(40)], [1] * 40,
                                 10.0, 5.0)
        await store.sync_counter("c", 1.0, 1.0)
        store.start_sweeper(0.02)
        task = store._sweeper_task
        store.start_sweeper(0.02)  # idempotent
        assert store._sweeper_task is task
        clock.advance_seconds(86_401)
        for _ in range(250):
            if store.metrics.slots_evicted == 41:
                break
            await asyncio.sleep(0.02)
        assert store.metrics.slots_evicted == 41
        await store.aclose()
        assert task.done() and store._sweeper_task is None

    asyncio.run(main())


def test_limiters_run_unchanged_over_a_remote_store():
    async def main():
        async with _Server("port") as srv:
            remote = RemoteBucketStore(address=srv.address,
                                       clock=srv.clock)
            lim = PartitionedRateLimiter(TokenBucketOptions(
                token_limit=5, tokens_per_period=1, instance_name="p"),
                remote)
            leases = await w(asyncio.gather(*(lim.acquire_async("a")
                                              for _ in range(32))))
            assert sum(map(bool, leases)) == 5
            assert await asyncio.to_thread(lim.available_permits, "a") == 0
            bulk = await w(lim.acquire_many(["x", "y", "x"], permits=3))
            assert bulk.granted.tolist() == [True, True, False]
            tb = TokenBucketRateLimiter(TokenBucketOptions(
                token_limit=3, tokens_per_period=1, instance_name="t"),
                remote)
            got = [bool(await w(tb.acquire_async(1))) for _ in range(4)]
            assert got == [True, True, True, False]
            approx = [ApproximateTokenBucketRateLimiter(
                ApproximateTokenBucketOptions(
                    token_limit=20, tokens_per_period=2,
                    replenishment_period_s=1.0, instance_name="ap"),
                remote) for _ in range(2)]
            # The counter's first interval is the whole clock epoch; 80
            # syncs (each keeping 0.8 of the EWMA) bring it to the cadence.
            for _ in range(40):
                for lim2 in approx:
                    srv.clock.advance_seconds(0.5)
                    await w(lim2.refresh())
            assert [a._instance_count for a in approx] == [2, 2]
            for a in approx:
                await a.aclose()
            stats = await w(remote.stats())
            assert stats["requests_served"] > 0
            await remote.aclose()
            with pytest.raises(ConnectionError):
                await remote.ping()

    asyncio.run(main())


@pytest.mark.parametrize("coalesce", [True, False])
def test_blocking_callers_on_many_threads_share_one_client(coalesce):
    """More threads than cores call one client's blocking paths at once,
    with a short interpreter switch interval: no request is lost or doubled
    (a cap-100 bucket grants exactly 100 of 240 asks) and every thread
    finishes."""
    n_threads, per_thread = 12, 20

    async def main():
        async with _Server("port") as srv:
            cli = RemoteBucketStore(address=srv.address,
                                    coalesce_requests=coalesce)

            def worker(i):
                got = 0
                for j in range(per_thread):
                    got += cli.acquire_blocking("shared", 1, 100.0,
                                                0.0).granted
                    if j % 5 == 0:
                        cli.peek_blocking(f"p{i}", 3.0, 1.0)
                return got

            # Threads of their own: the server's readbacks use the loop's
            # default executor, which blocked callers must not fill.
            loop = asyncio.get_running_loop()
            old = sys.getswitchinterval()
            sys.setswitchinterval(1e-5)
            try:
                with ThreadPoolExecutor(n_threads) as pool:
                    grants = await w(asyncio.gather(*(
                        loop.run_in_executor(pool, worker, i)
                        for i in range(n_threads))), 60)
            finally:
                sys.setswitchinterval(old)
            await cli.aclose()
            return grants

    grants = asyncio.run(main())
    assert len(grants) == n_threads and sum(grants) == 100


def test_client_timeout_and_dial_failure():
    async def main():
        async def silent(reader, writer):
            await reader.read()  # never answers
            writer.close()

        quiet = await asyncio.start_server(silent, "127.0.0.1", 0)
        port = quiet.sockets[0].getsockname()[1]
        cli = RemoteBucketStore(address=("127.0.0.1", port),
                                request_timeout_s=0.2,
                                coalesce_requests=False)
        with pytest.raises(StoreTimeoutError):
            await w(cli.acquire("k", 1, 5.0, 1.0))
        assert cli.resilience_stats()["timeouts"] == 1
        await cli.aclose()
        quiet.close()
        await w(quiet.wait_closed())
        # A refused dial: three tries (the policy's), each after the
        # backoff window the failed one armed.
        dead = RemoteBucketStore(address=("127.0.0.1", port),
                                 resilience_seed=1)
        with pytest.raises(ConnectionError):
            await w(dead.ping())
        stats = dead.resilience_stats()
        assert stats["connect_failures"] == 3 and stats["backing_off"]
        assert stats["retries"] == 2
        await dead.aclose()

    asyncio.run(main())


def test_console_server_starts_answers_and_exits_on_sigterm():
    proc = _console("--device", "cpu", "--slots", "1024",
                    "--sweep-period", "0.5")
    try:
        _, (host, port) = _console_address(proc)

        async def main():
            cli = JRemote(address=(host, int(port)))
            await w(cli.ping())
            res = await w(asyncio.gather(*(cli.acquire("five", 1, 5.0, 1.0)
                                           for _ in range(32))))
            assert sum(r.granted for r in res) == 5
            stats = await w(cli.stats())
            assert {"connections_served", "requests_served",
                    "serving_p50_ms", "serving_p99_ms", "serving_samples",
                    "requests_shed", "stats_resets", "store"} <= set(stats)
            await cli.aclose()

        asyncio.run(main())
        assert "shutdown complete" in _stop(proc)
    finally:
        _kill(proc)


def test_new_modules_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import distributedratelimiting.redis_tpu_torch.runtime.server\n"
        "import distributedratelimiting.redis_tpu_torch.runtime.remote\n"
        "import distributedratelimiting.redis_tpu_torch.runtime.checkpoint\n"
        "import distributedratelimiting.redis_tpu_torch.runtime.wire\n"
        "import distributedratelimiting.redis_tpu_torch.utils.resilience\n"
        "import distributedratelimiting.redis_tpu_torch.runtime.audit\n"
        "import distributedratelimiting.redis_tpu_torch.utils.faults\n"
        "import distributedratelimiting.redis_tpu_torch.utils.flight_recorder\n"
        "import distributedratelimiting.redis_tpu_torch.utils.heavy_hitters\n"
        "import distributedratelimiting.redis_tpu_torch.utils.metrics\n"
        "import distributedratelimiting.redis_tpu_torch.utils.slo\n"
        "import distributedratelimiting.redis_tpu_torch.utils.tracing\n"
        "print(any(m == 'jax' or m.startswith(('jax.', "
        "'distributedratelimiting.redis_tpu.'))\n"
        "          for m in sys.modules if sys.modules[m] is not None))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]
    # And no module of the port names the JAX package in an import.
    pkg = os.path.join(ROOT, "distributedratelimiting", "redis_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                text = open(os.path.join(dirpath, name)).read()
                assert "distributedratelimiting.redis_tpu import" not in text
                assert "distributedratelimiting.redis_tpu." not in text, name
