"""The port's bench entry point and its three kernels' plain versions.

- ``acquire_scan_packed24``, ``acquire_scan_compact_fused`` and
  ``acquire_batch`` (both ``handle_duplicates``) against the JAX package's
  functions of those names, on the same seeded numpy inputs: K = 4 batches
  of B = 64 on a 256-slot table, Zipf(1.5) slots repeated past the
  capacity, ``SLOT24_PAD`` and -1 padding, ids >= N, zero counts.
  Tolerance, at a refill rate of 1/64 a tick: none. Grants, remaining and
  every state field are equal bit for bit: every count is a whole number
  and every in-batch demand stays far below 2^24, so each subtraction the
  two packages make is exact (with ``handle_duplicates=False`` a slot's
  balance goes below zero by whole steps from its refilled value, still
  exact at these sizes), and ``elapsed * rate`` is exact. At a rate of
  0.013 a tick XLA on the CPU contracts ``tokens + elapsed * rate`` into
  one fused multiply-add, which the port never does: grants, ``last_ts``
  and ``exists`` equal, tokens and remaining within 4 float32 spacings of
  the capacity.
- ``pack_slots24``: the same bytes as JAX's, and the same ``ValueError``.
- The card wrappers' whole-batch split, with ``SCAN_MAX_ROWS`` set small:
  the pieces, decided in order, give JAX's one-scan answer.
- The card store's cap: ``max_batch`` above the flush's 4096 rows raises,
  checked without a GPU.
- The bench (``python -m distributedratelimiting.redis_tpu_torch.bench``)
  on ``--device cpu`` at tiny sizes: its JSON lines, its ported and
  unported keys, a failing section, and its refusal to run without a card.
  Its child-process sections (``nproc``, ``serving_p99_colocated``,
  ``serving_p99_instant``) run there against stub children (a few lines of
  Python that answer as the real ones do), which also fail on purpose: a
  failed child is an error naming its stderr, with null keys, never a zero.
  One test runs the real children at tiny sizes.
"""

import asyncio
import io
import json
import subprocess
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu_torch import bench
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import kernels as TK
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    DeviceBucketStore,
)

torch.set_num_threads(1)

N = 256
KB = (4, 64)
CAP = 10.0
RATE = 1 / 64  # dyadic: elapsed * rate is exact
#: The refill rates: exact arithmetic, and one XLA contracts into an FMA.
RATES = [RATE, 0.013]
FMA_ATOL = 4 * float(np.spacing(np.float32(CAP)))
NOW = 50_000


def _state_np(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, CAP, N).astype(np.float32),
            rng.integers(NOW - 3000, NOW + 50, N).astype(np.int32),
            rng.random(N) < 0.6)


def _jax(s):
    return JK.BucketState(*(jnp.asarray(a) for a in s))


def _torch(s):
    return TK.BucketState(*(torch.tensor(a) for a in s))


def _assert_state_equal(tstate, jstate, rate=RATE):
    for name in ("tokens", "last_ts", "exists"):
        _assert_equal(getattr(tstate, name), getattr(jstate, name), rate,
                      name)


def _assert_equal(got, want, rate=RATE, what=""):
    """Bit-equal; floats within FMA_ATOL where XLA's refill is an FMA."""
    got, want = got.numpy(), np.asarray(want)
    if rate == RATE or got.dtype != np.float32:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=FMA_ATOL, rtol=0,
                                   err_msg=what)


def _assert_results(tg, tr, jg, jr, rate):
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    _assert_equal(tr, jr, rate, "remaining")


def _slots(rng, shape, pad):
    """Zipf(1.5) slots (a few hot slots take more rows than CAP), padding
    ``pad`` on ~8% of the rows and ids >= N on ~5%."""
    slots = np.minimum(rng.zipf(1.5, shape) - 1, N - 1).astype(np.int64)
    slots[rng.random(shape) < 0.08] = pad
    slots[rng.random(shape) < 0.05] = N + 7
    return slots


def _nows(k):
    return np.array([NOW + 300 * (3 * i // k) for i in range(k)], np.int32)


def _hot_past_capacity(slots):
    """Some slot takes more rows in one batch than the bucket holds."""
    rows = slots.reshape(-1, slots.shape[-1])
    return any(np.bincount(r[(r >= 0) & (r < N)]).max() > CAP for r in rows)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed24_matches_jax(seed, rate):
    rng = np.random.default_rng(seed)
    slots = _slots(rng, KB, TK.SLOT24_PAD)
    assert _hot_past_capacity(slots)
    packed = TK.pack_slots24(slots)
    s = _state_np(seed + 10)
    js, jg, jr = JK.acquire_scan_packed24(_jax(s), jnp.asarray(packed),
                                          jnp.asarray(_nows(KB[0])), CAP, rate)
    ts, tg, tr = TK.acquire_scan_packed24(
        _torch(s), torch.from_numpy(packed), torch.from_numpy(_nows(KB[0])),
        CAP, rate)
    _assert_results(tg, tr, jg, jr, rate)
    _assert_state_equal(ts, js, rate)
    assert 0 < int(tg.sum()) < tg.numel()


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_fused_matches_jax(seed, rate):
    rng = np.random.default_rng(seed)
    slots = _slots(rng, KB, -1).astype(np.int32)
    counts = rng.integers(0, 4, KB).astype(np.uint8)  # zero-count probes
    assert _hot_past_capacity(slots) and (counts == 0).any()
    fused = TK.pack_compact5(slots, counts)
    np.testing.assert_array_equal(fused, JK.pack_compact5(slots, counts))
    s = _state_np(seed + 20)
    js, jg, jr = JK.acquire_scan_compact_fused(
        _jax(s), jnp.asarray(fused), jnp.asarray(_nows(KB[0])), CAP, rate)
    ts, tg, tr = TK.acquire_scan_compact_fused(
        _torch(s), torch.from_numpy(fused), torch.from_numpy(_nows(KB[0])),
        CAP, rate)
    _assert_results(tg, tr, jg, jr, rate)
    _assert_state_equal(ts, js, rate)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("handle_duplicates", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_acquire_batch_matches_jax(seed, handle_duplicates, rate):
    rng = np.random.default_rng(seed)
    b = KB[1]
    slots = _slots(rng, (b,), -1).astype(np.int32)
    counts = rng.integers(0, 4, b).astype(np.int32)
    valid = rng.random(b) < 0.9  # invalid rows with real slots too
    assert _hot_past_capacity(slots)
    s = _state_np(seed + 30)
    js, jg, jr = JK.acquire_batch(
        _jax(s), jnp.asarray(slots), jnp.asarray(counts), jnp.asarray(valid),
        jnp.int32(NOW), CAP, rate, handle_duplicates=handle_duplicates)
    ts, tg, tr = TK.acquire_batch(
        _torch(s), torch.from_numpy(slots), torch.from_numpy(counts),
        torch.from_numpy(valid), NOW, CAP, rate,
        handle_duplicates=handle_duplicates)
    _assert_results(tg, tr, jg, jr, rate)
    _assert_state_equal(ts, js, rate)
    if not handle_duplicates:
        # JAX's semantics, kept: a hot slot's rows all decide from one
        # balance, which then goes below zero.
        assert (ts.tokens < 0).any()


def test_pack_slots24_matches_jax():
    rng = np.random.default_rng(5)
    slots = rng.integers(0, TK.SLOT24_PAD + 1, (3, 50))
    slots[0, :3] = (0, TK.SLOT24_PAD, TK.SLOT24_PAD - 1)
    np.testing.assert_array_equal(TK.pack_slots24(slots),
                                  JK.pack_slots24(slots))
    assert TK.SLOT24_PAD == JK.SLOT24_PAD
    for bad in (-1, TK.SLOT24_PAD + 1):
        bad_slots = np.array([3, bad])
        with pytest.raises(ValueError, match="SLOT24_PAD") as ours:
            TK.pack_slots24(bad_slots)
        with pytest.raises(ValueError) as theirs:
            JK.pack_slots24(bad_slots)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("rows,pieces", [(64, 8), (128, 4), (192, 3),
                                         (100, 8)])
@pytest.mark.parametrize("width", [3, 5])
def test_wrapper_split_matches_one_jax_scan(monkeypatch, rows, pieces, width):
    """K = 8 batches of 64 rows through the wrappers with SCAN_MAX_ROWS set
    small: the whole-batch pieces, decided one after another, equal one
    JAX scan over all eight."""
    monkeypatch.setattr(ck, "SCAN_MAX_ROWS", rows)
    k, b = 8, 64
    assert len(ck._pieces(k, b)) == pieces
    rng = np.random.default_rng(rows + width)
    nows = np.array([NOW + 200 * (i // 3) for i in range(k)], np.int32)
    s = _state_np(rows)
    if width == 3:
        op = TK.pack_slots24(_slots(rng, (k, b), TK.SLOT24_PAD))
        js, jg, jr = JK.acquire_scan_packed24(_jax(s), jnp.asarray(op),
                                              jnp.asarray(nows), CAP, RATE)
        wrapper = ck.acquire_scan_packed24
    else:
        op = TK.pack_compact5(_slots(rng, (k, b), -1).astype(np.int32),
                              rng.integers(0, 4, (k, b)).astype(np.uint8))
        js, jg, jr = JK.acquire_scan_compact_fused(
            _jax(s), jnp.asarray(op), jnp.asarray(nows), CAP, RATE)
        wrapper = ck.acquire_scan_compact_fused
    ts = _torch(s)
    before = dict(ck.launches)
    out = wrapper(ts, torch.from_numpy(op), torch.from_numpy(nows), CAP,
                  RATE)
    assert ck.launches == before  # the CPU runs the plain version
    assert out.shape == (k, 2, b)
    _assert_results(out[:, 0] > 0.5, out[:, 1], jg, jr, RATE)
    _assert_state_equal(ts, js)


def test_split_refuses_wide_batches():
    with pytest.raises(ValueError, match="8192"):
        ck._pieces(2, ck.SCAN_MAX_BATCH + 1)
    assert ck._pieces(32, 8192) == [(0, 16), (16, 32)]
    assert ck._pieces(16, 8192) == [(0, 16)]


@pytest.mark.parametrize("handle_duplicates", [True, False])
def test_acquire_batch_wrapper_on_cpu(handle_duplicates):
    rng = np.random.default_rng(9)
    slots = _slots(rng, (64,), -1).astype(np.int32)
    counts = rng.integers(0, 4, 64).astype(np.int32)
    valid = slots >= 0
    s = _state_np(9)
    ts, want = _torch(s), _torch(s)
    out = ck.acquire_batch(ts, torch.from_numpy(slots),
                           torch.from_numpy(counts), torch.from_numpy(valid),
                           NOW, CAP, RATE,
                           handle_duplicates=handle_duplicates)
    _, g, r = TK.acquire_batch(want, torch.from_numpy(slots),
                               torch.from_numpy(counts),
                               torch.from_numpy(valid), NOW, CAP, RATE,
                               handle_duplicates=handle_duplicates)
    np.testing.assert_array_equal(out.numpy(),
                                  torch.stack([g.float(), r]).numpy())
    _assert_state_equal(ts, want)
    with pytest.raises(ValueError, match="at most 8192"):
        ck.acquire_batch(ts, *(torch.zeros(8193, dtype=d)
                               for d in (torch.int32, torch.int32,
                                         torch.bool)), NOW, CAP, RATE)


def test_card_store_cap_is_the_flush_width(monkeypatch):
    """The scan takes 8192-row batches now, but a card store's one-batch bulk
    chunks are flushes: its max_batch stays at most FLUSH_MAX_BATCH."""
    assert ck.SCAN_MAX_BATCH == 8192 > ck.FLUSH_MAX_BATCH == 4096
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="max_batch 8192 > 4096"):
        DeviceBucketStore(max_batch=8192)
    DeviceBucketStore(max_batch=4096)  # touches no device yet


#: Every ported section at a tiny size (the CPU runs the plain versions).
TINY = {
    "link_probe": {"nbytes": 4096, "reps": 2, "windows": 1},
    "link_rtt_probe": {"reps": 3, "fetches": 2},
    "headline": {"n_slots": 4096, "batch": 64, "scan_k": 4, "iters": 2,
                 "windows": 1},
    "compact": {"batch": 64, "scan_k": 2, "iters": 2, "windows": 1},
    "single_batch": {"batch": 64, "iters": 2, "windows": 1},
    "e2e_bulk": {"n_slots": 4096, "max_batch": 64, "n": 256,
                 "pool_size": 1000, "calls": 2},
    "remote_bulk": {"n_slots": 4096, "max_batch": 64, "n": 256,
                    "pool_size": 1000, "calls": 2},
    "e2e_async": {"n_slots": 4096, "max_batch": 64, "workers": 32,
                  "reqs_per_worker": 2, "warm_workers": 8, "low_workers": 4,
                  "low_reqs": 8, "keys": 100},
    "serving_p99": {"n_slots": 4096, "max_batch": 64, "depth": 8, "reqs": 8,
                    "warm_reqs": 2, "depth_low": 2, "keys": 100},
    "nproc": {"clients": 2, "workers": 4, "reqs": 5, "warm_workers": 2,
              "warm_reqs": 2},
    "serving_p99_colocated": {"samples": 64, "min_reqs": 2, "warm_reqs": 1},
    "serving_p99_instant": {"samples": 64, "min_reqs": 2, "warm_reqs": 1},
    "sweep_ok": {"n_slots": 256},
}

#: A stand-in for the bench's children: the same flags and result lines,
#: without their stores. ``STUB_FAIL`` names a flag whose child fails.
STUB_CHILD = r"""
import json, os, sys
flag = sys.argv[1]
if os.environ.get("STUB_FAIL") == flag:
    print("stub child went wrong on purpose", file=sys.stderr)
    sys.exit(3)
if flag == "--serving-server-child":
    print(json.dumps({"host": "127.0.0.1", "port": 9}), flush=True)
    sys.stdin.read()
elif flag == "--serving-load-child":
    d = {"p99_ms": 1.5, "p50_ms": 0.5, "samples": 10, "flush_p99_ms": 0.25,
         "flush_p50_ms": 0.125}
    print(json.dumps({"d4": dict(d, p99_ms=0.75), "d16": dict(d, p99_ms=1.0),
                      "d64": d}))
elif flag == "--nproc-client":
    if os.environ.get("STUB_FAIL") == "silent":
        sys.exit(0)  # no result line
    print(json.dumps({"rate": 100.0 + int(sys.argv[4])}))
"""


@pytest.fixture(autouse=True)
def stub_children(monkeypatch):
    """Every bench child runs :data:`STUB_CHILD` unless a test lifts it."""
    monkeypatch.setattr(bench, "_child_cmd", lambda *args: [
        sys.executable, "-c", STUB_CHILD, *args])

PORTED_KEYS = [k for _, keys in bench.SECTIONS for k in keys] + [
    "vs_baseline", "e2e_async_link_rtt_ms", "headline_wall_ms_per_dispatch"]


def _run_tiny():
    buf = io.StringIO()
    result, rc = bench.run(torch.device("cpu"), TINY, out=buf)
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    return result, rc, lines


def test_bench_on_cpu_prints_every_section():
    result, rc, lines = _run_tiny()
    assert rc == 0
    assert len(lines) == len(bench.SECTIONS) + 2
    assert all(line["partial"] for line in lines[:-1])
    assert lines[-1] == result and result["partial"] is False
    assert result["platform"] == "cpu"
    assert result["n_keys"] == 4096 and result["batch"] == 64
    for key in PORTED_KEYS:
        assert result[key] is not None, key
    assert result["pallas_sweep_ok"] is True
    assert result["serving_p99_samples"] == 8 * 8
    assert result["serving_p99_d4_samples"] == 2 * 8
    # The stub children's answers, in their keys: a client's rate each.
    assert result["e2e_async_nproc_decisions_per_sec"] == 100.0 + 101.0
    assert result["e2e_async_nproc_clients"] == 2
    assert (result["serving_p99_colocated_ms"],
            result["serving_p50_colocated_ms"],
            result["serving_p99_colocated_d4_ms"],
            result["serving_p99_colocated_d16_ms"],
            result["flush_p99_colocated_ms"],
            result["flush_p50_colocated_ms"]) == (1.5, 0.5, 0.75, 1.0, 0.25,
                                                  0.125)
    assert result["serving_p99_instant_d16_ms"] == 1.0
    for name, _ in bench.SECTIONS:
        assert result["section_status"][name] == "ok"
    for name, (item, keys) in bench.NOT_PORTED.items():
        assert result["section_status"][name] == (
            f"not_ported: ROADMAP Queue {item}")
        assert all(result[k] is None for k in keys)
    assert {item for item, _ in bench.NOT_PORTED.values()} == {"A5", "A6",
                                                               "A12"}
    assert result["reduced"]["sizes"] == TINY
    assert "e2e_bulk.max_batch" in result["reduced"]
    # A section's keys are set in the line that reports it "ok".
    for line in lines:
        if line["section_status"].get("headline") == "ok":
            assert line["value"] is not None


def test_bench_section_error_exits_1_after_the_last_line(monkeypatch):
    async def broken(*args, **kwargs):
        raise RuntimeError("forced")

    monkeypatch.setattr(bench, "bench_e2e_bulk", broken)
    result, rc, lines = _run_tiny()
    assert rc == 1
    assert lines[-1]["partial"] is False
    status = result["section_status"]
    assert status["e2e_bulk"] == "error: RuntimeError: forced"
    assert result["e2e_bulk_decisions_per_sec"] is None
    assert status["remote_bulk"] == status["sweep_ok"] == "ok"


@pytest.mark.parametrize("flag,section", [
    ("--nproc-client", "nproc"),
    ("silent", "nproc"),
    ("--serving-server-child", "serving_p99_colocated"),
    ("--serving-load-child", "serving_p99_colocated"),
])
def test_a_failed_child_fails_its_section_with_null_keys(monkeypatch, flag,
                                                          section):
    """A child that exits non-zero, prints no result or never prints its
    address fails its section: an error naming the child (and its stderr's
    tail), the section's keys null and exit code 1 — never a rate of 0."""
    monkeypatch.setenv("STUB_FAIL", flag)
    result, rc, lines = _run_tiny()
    assert rc == 1 and lines[-1]["partial"] is False
    status = result["section_status"]
    failed = {name for name, st in status.items() if st.startswith("error")}
    want = ({section, "serving_p99_instant"}
            if section == "serving_p99_colocated" else {section})
    assert failed == want
    assert "child" in status[section]
    if flag != "silent":
        assert "wrong on purpose" in status[section]
    keys = dict(bench.SECTIONS)[section]
    assert all(result[k] is None for k in keys)
    assert status["sweep_ok"] == "ok"


def test_the_real_children_run_on_the_cpu(monkeypatch):
    """The children themselves (no stub), at tiny sizes: the serial and the
    device store behind a server child, and two nproc clients."""
    monkeypatch.undo()  # the autouse stub
    dev = torch.device("cpu")
    instant = bench.bench_serving_children(
        dev, "instant", **TINY["serving_p99_instant"])
    device = bench.bench_serving_children(
        dev, "device", **TINY["serving_p99_colocated"])
    for out in (instant, device):
        assert sorted(out) == ["d16", "d4", "d64"]
        # samples: the measured requests plus the closing stats request
        assert out["d64"]["samples"] == 64 * 2 + 1
        assert out["d4"]["p99_ms"] > 0
    assert instant["d64"]["flush_p99_ms"] is None
    assert device["d64"]["flush_p99_ms"] > 0
    rate, n = asyncio.run(bench.bench_nproc(dev, **TINY["nproc"]))
    assert n == 2 and rate > 0


def test_child_flags_parse(monkeypatch, capsys):
    seen = {}
    monkeypatch.setattr(bench, "_serving_load_child",
                        lambda *a: seen.setdefault("load", a) and {"x": 1})
    monkeypatch.setattr(bench, "_nproc_client",
                        lambda *a: seen.setdefault("nproc", a) and {"y": 2})
    monkeypatch.setattr(bench, "_serving_server_child",
                        lambda *a: seen.setdefault("server", a))
    assert bench.main(["--serving-load-child", "h", "7", "64", "2",
                       "1"]) == 0
    assert bench.main(["--nproc-client", "h", "7", "3", "4", "5", "2",
                       "2"]) == 0
    assert bench.main(["--serving-server-child", "device", "--device",
                       "cpu"]) == 0
    assert seen == {"load": ("h", 7, 64, 2, 1),
                    "nproc": ("h", 7, "3", 4, 5, 2, 2),
                    "server": ("device", "cpu")}
    assert capsys.readouterr().out.splitlines() == ['{"x": 1}', '{"y": 2}']


def test_bench_budget_skips_sections(monkeypatch):
    monkeypatch.setattr(bench, "BUDGET_S", 0.0)
    result, rc, lines = _run_tiny()
    assert rc == 0 and lines[-1]["partial"] is False
    assert all(result["section_status"][name] == "skipped_budget"
               for name, _ in bench.SECTIONS)
    assert result["value"] is None


def test_bench_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "--device cpu" in captured.err
    assert bench.main(["--device"]) == 2


def test_bench_module_imports_without_jax_and_exits_without_a_card():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from distributedratelimiting.redis_tpu_torch import bench\n"
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('distributedratelimiting.redis_tpu.') "
            "for m in sys.modules if sys.modules[m] is not None)\n"
            "sys.exit(bench.main([]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""
