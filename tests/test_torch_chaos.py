"""The port's chaos seam and overload gates, held to the JAX package.

- ``utils/faults.py``: the seeded per-seam schedule (``schedule_preview``,
  the realized ``events``) and the retry-storm model (``storm_schedule``)
  equal to JAX's for the same seeds and rules, field for field; the
  ``DRL_TPU_FAULTS_CONFIG`` file installs an injector in a fresh process.
- The server's doomed-work, retry-shed and overflow-pool answers: the same
  frames served by the port's server and JAX's give the same reply bytes,
  and a gated frame leaves the store untouched.
- Seeded faults on the client's and the server's seams: cap-5 x 32 -> 5
  still holds (no grant lost or doubled by a retried or failed request).

Tolerance 0 throughout: every compared value is a schedule entry, a count
or a reply byte.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

from distributedratelimiting.redis_tpu.runtime import wire as jwire
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.server import (
    BucketStoreServer as JServer,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    InProcessBucketStore as JInProcess,
)
from distributedratelimiting.redis_tpu.utils import faults as jfaults
from distributedratelimiting.redis_tpu_torch import (
    BucketStoreServer,
    DeviceBucketStore,
    ManualClock,
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.runtime import wire
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    InProcessBucketStore,
)
from distributedratelimiting.redis_tpu_torch.utils import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 30.0


def _rules(mod):
    """One rule set of every kind, in either package's classes."""
    R = mod.FaultRule
    return {
        "server.dispatch": (R(kind="delay", probability=0.3, delay_s=0.01,
                              jitter_s=0.02),
                            R(kind="error", probability=0.1, after=5)),
        "client.write": (R(kind="partial_frame", probability=0.05),
                         R(kind="reset", probability=0.1, until=40,
                           max_faults=2)),
        "client.read": (R(kind="blackhole", probability=0.02,
                          delay_s=0.5),),
        "audit.leak": (R(kind="error", probability=0.5, max_faults=7),),
        "store.flush": (R(kind="error", probability=1.0, max_faults=1),),
    }


def _events(evs):
    return [dataclasses.astuple(e) for e in evs]


@pytest.mark.parametrize("seed", [0, 7, 20260803])
def test_schedule_preview_matches_jax(seed):
    mine = faults.FaultInjector(seed, _rules(faults))
    theirs = jfaults.FaultInjector(seed, _rules(jfaults))
    for seam in _rules(faults):
        got = _events(mine.schedule_preview(seam, 200))
        want = _events(theirs.schedule_preview(seam, 200))
        assert got == want, seam
        # The live decisions realize the preview (the determinism
        # contract), on both packages alike.
        for _ in range(200):
            mine.decide(seam)
            theirs.decide(seam)
    assert _events(mine.events) == _events(theirs.events)
    assert mine.events, "no rule fired at all"


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (3, {"n_requests": 64, "client_timeout_s": 0.02, "max_retries": 5}),
    (11, {"tenants": ("a", "b", "c"), "priorities": (0, 2),
          "deadline_s": 0.5, "backoff_mult": 1.5, "cost_range": (2, 9)}),
])
def test_storm_schedule_matches_jax(seed, kw):
    got = faults.storm_schedule(seed, **kw)
    want = jfaults.storm_schedule(seed, **kw)
    assert [dataclasses.astuple(e) for e in got] == [
        dataclasses.astuple(e) for e in want]
    assert any(e.attempt > 0 for e in got)  # the storm has retries


def test_faults_config_file_installs_in_a_fresh_process(tmp_path):
    """``DRL_TPU_FAULTS_CONFIG`` (the JAX package's variable: one file
    drives either package) installs the port's injector at import."""
    cfg = tmp_path / "faults.json"
    cfg.write_text(json.dumps({"seed": 5, "rules": {"server.dispatch": [
        {"kind": "delay", "probability": 0.5, "delay_s": 0.01}]}}))
    code = ("from distributedratelimiting.redis_tpu_torch.utils import "
            "faults\n"
            "inj = faults.get_injector()\n"
            "print(inj.seed, [e.occurrence for e in "
            "inj.schedule_preview('server.dispatch', 20)])\n")
    env = dict(os.environ, PYTHONPATH=ROOT, DRL_TPU_FAULTS_CONFIG=str(cfg))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    want = jfaults.FaultInjector(5, {"server.dispatch": (jfaults.FaultRule(
        kind="delay", probability=0.5, delay_s=0.01),)})
    occ = [e.occurrence for e in want.schedule_preview("server.dispatch", 20)]
    assert out.stdout.split(" ", 1) == ["5", f"{occ}\n"]


# -- the overload gates, frame for frame --------------------------------------

#: Serving latencies recorded into both servers before the gated frames: the
#: doomed gate reads p99 = this sample's bucket edge on both.
P99_SAMPLE_S = 0.05


#: Both stores run on a manual clock at this tick: replies compare byte
#: for byte, ``remaining`` included.
START = 1 << 20


def _port_stores():
    return {"inprocess": lambda: InProcessBucketStore(
                clock=ManualClock(START)),
            "device": lambda: DeviceBucketStore(
                device="cpu", n_slots=1024, clock=ManualClock(START))}


def _servers(port_store, **kw):
    srv = BucketStoreServer(port_store(), observability=False, **kw)
    jsrv = JServer(JInProcess(clock=JClock(START)), observability=False,
                   **kw)
    for s in (srv, jsrv):
        for _ in range(100):
            s.serving_latency.record(P99_SAMPLE_S)
    return srv, jsrv


async def _both(srv, jsrv, frame_of):
    """Serve one frame body (the frame past its u32 length) on each
    server; the two reply frames."""
    now = time.perf_counter()
    got = await asyncio.wait_for(srv.handle_frame_body(
        frame_of(wire)[4:], arrival_s=now), LIMIT_S)
    want = await asyncio.wait_for(jsrv.handle_frame_body(
        frame_of(jwire)[4:], arrival_s=now), LIMIT_S)
    return got, want


def _text(reply: bytes) -> str:
    """An error or text reply's string."""
    return wire.decode_response(reply[4:])[2][0]


@pytest.mark.parametrize("backing", sorted(_port_stores()))
def test_scalar_gates_answer_jax_words(backing):
    srv, jsrv = _servers(_port_stores()[backing])

    async def main():
        async def peek():
            return (await asyncio.to_thread(srv.store.peek_blocking, "k",
                                            5.0, 1.0),
                    await asyncio.to_thread(jsrv.store.peek_blocking, "k",
                                            5.0, 1.0))

        before = await peek()
        # Disarmed: a retry and a short deadline are served.
        got, want = await _both(srv, jsrv, lambda w: w.encode_request(
            1, w.OP_ACQUIRE, "k", 1, 5.0, 1.0, deadline_s=0.01, attempt=2))
        assert got == want and got[9] == wire.RESP_DECISION
        served = await peek()
        assert served[0] == served[1] < before[0]
        for s in (srv, jsrv):
            s.set_doomed_gate(True)
            s.set_retry_shed(True)
        # Doomed: 10 ms of budget against a p99 of ~50 ms.
        got, want = await _both(srv, jsrv, lambda w: w.encode_request(
            2, w.OP_ACQUIRE, "k", 1, 5.0, 1.0, deadline_s=0.01))
        assert got == want
        assert _text(got).startswith(
            "doomed: 10.0ms budget cannot cover p99 ")
        # Retry-shed: an attempt-stamped frame, no deadline.
        got, want = await _both(srv, jsrv, lambda w: w.encode_request(
            3, w.OP_ACQUIRE, "k", 1, 5.0, 1.0, attempt=1))
        assert got == want
        assert _text(got) == (
            "retry shed: attempt 1 denied while the retry-storm defense "
            "is armed")
        # A first attempt with budget to spare still goes through.
        got, want = await _both(srv, jsrv, lambda w: w.encode_request(
            4, w.OP_ACQUIRE, "k", 1, 5.0, 1.0, deadline_s=5.0))
        assert got == want and got[9] == wire.RESP_DECISION
        after = await peek()
        assert after[0] == after[1]
        for s in (srv, jsrv):
            assert (s.requests_doomed, s.retries_shed, s.requests_shed) == (
                1, 1, 2)
            assert s.retry_attempts_seen == 2
        assert srv._goodput_numeric_stats() == jsrv._goodput_numeric_stats()
        assert srv._retry_numeric_stats() == jsrv._retry_numeric_stats()
        return before, served, after

    before, served, after = asyncio.run(main())
    # The gated frames left the store as it was: only the two served
    # grants moved it.
    assert before == (5.0, 5.0) and served == (4.0, 4.0)
    assert after == (3.0, 3.0)


def _reserve(seq, w, **req):
    body = {"rid": f"r{seq}", "tenant": "t", "key": "k", "a": 100.0,
            "b": 1.0, "ta": 1000.0, "tb": 10.0, **req}
    return w.encode_request(seq, w.OP_RESERVE, json.dumps(body))


@pytest.mark.parametrize("backing", sorted(_port_stores()))
def test_reserve_gates_and_route_answer_jax_words(backing):
    pool = {"pool": "batch", "ta": 500.0, "tb": 5.0, "priority": 1}
    srv, jsrv = _servers(_port_stores()[backing], overflow_pool=pool)

    async def main():
        for s in (srv, jsrv):
            s.set_doomed_gate(True)
            s.set_retry_shed(True)
        replies = []
        for seq, req in enumerate((
                {"estimate": 10, "attempt": 1},             # retry shed
                {"estimate": 10, "deadline_s": 0.01},       # doomed
                {"estimate": 5000, "deadline_s": 1.0},      # routed
                {"estimate": 5000, "deadline_s": 1.0,
                 "priority": 1},                           # not interactive
                {"estimate": 10, "deadline_s": 1.0}), 1):  # granted
            got, want = await _both(
                srv, jsrv, lambda w, s=seq, r=req: _reserve(s, w, **r))
            assert got == want, req
            replies.append(_text(got))
        for s in (srv, jsrv):
            assert (s.retries_shed, s.requests_doomed,
                    s.reserves_routed) == (1, 1, 1)
        return replies

    shed, doomed, routed, batch, granted = asyncio.run(main())
    assert json.loads(shed) == {"granted": False, "reserved": 0.0,
                                "remaining": 0.0, "debt": 0.0,
                                "duplicate": False, "shed": "retry"}
    assert json.loads(doomed)["shed"] == "doomed"
    assert routed.startswith("route-to-pool ")
    assert json.loads(routed[routed.index("{"):]) == pool
    assert json.loads(batch)["granted"] is False  # 5000 > the budget
    assert json.loads(granted)["granted"] is True


def test_seeded_faults_on_both_seams_keep_cap5():
    """Delays and errors on the server's dispatch seam and resets on the
    client's dial: 32 concurrent acquires on a cap-5 key grant exactly 5
    (a failed request is an error, never a grant), retried reserves and
    settles debit nothing twice."""
    rules = {
        "server.dispatch": (
            faults.FaultRule(kind="delay", probability=0.5, delay_s=0.002,
                             jitter_s=0.004),
            faults.FaultRule(kind="error", probability=0.2)),
        "client.connect": (faults.FaultRule(kind="reset", probability=1.0,
                                            max_faults=1),),
    }
    srv = BucketStoreServer(DeviceBucketStore(device="cpu", n_slots=1024))

    async def main():
        await srv.start()
        cli = RemoteBucketStore(address=(srv.host, srv.port),
                                coalesce_requests=False)
        inj = faults.FaultInjector(20260803, rules)
        faults.install(inj)
        try:
            outs = await asyncio.wait_for(asyncio.gather(
                *(cli.acquire("five", 1, 5.0, 1e-9) for _ in range(32)),
                return_exceptions=True), LIMIT_S)
        finally:
            faults.uninstall()
        rid = "storm-r"
        res = [await asyncio.wait_for(cli.reserve(
            rid, "tenant", "key", 10.0, 100.0, 1e-9, 50.0, 1e-9,
            attempt=i), LIMIT_S) for i in range(3)]
        settle = await asyncio.wait_for(cli.settle(rid, "tenant", 4.0),
                                        LIMIT_S)
        again = await asyncio.wait_for(cli.settle(rid, "tenant", 4.0),
                                       LIMIT_S)
        bal = await asyncio.to_thread(srv.store.peek_blocking, "tenant",
                                      100.0, 1e-9)
        await cli.aclose()
        await srv.aclose()
        return inj, outs, res, settle, again, bal

    inj, outs, res, settle, again, bal = asyncio.run(main())
    decided = [o for o in outs if not isinstance(o, BaseException)]
    errors = [o for o in outs if isinstance(o, BaseException)]
    assert any(e.seam == "client.connect" for e in inj.events)
    assert any(e.seam == "server.dispatch" and e.kind == "error"
               for e in inj.events)
    assert all(isinstance(e, wire.RemoteStoreError) for e in errors)
    # A failed request was never decided: the decided ones grant exactly
    # min(5, decided) — no grant lost, none doubled.
    assert sum(o.granted for o in decided) == min(5, len(decided))
    assert len(decided) > 5
    # Retried reserves of one rid hold once; the settle refunds once.
    assert all(r.granted for r in res)
    assert [r.duplicate for r in res] == [False, True, True]
    assert settle.outcome == "settled" and again.outcome == "duplicate"
    assert bal == pytest.approx(100.0 - 4.0, abs=1e-3)
