"""The fingerprint directory's CUDA kernels against their plain versions, on
the card.

These tests need an NVIDIA GPU and ``nvcc`` and skip without one. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_fp_cuda.py

Tolerances. Which row wins a contested cell is the atomics' order on the
card and the last claimant row in the plain version, so tables compare BY
KEY (each key looked up in both tables, ``fp_directory.find_np``), not by
slot: a key is present in both or in neither, and its state fields are
equal (tokens within atol 1e-4, as the scan's: it subtracts each slot's
int64 sum once). Without window pressure (tables of 2^20 slots, a few
percent full, so that a launch's claims rarely contend) every row resolves
on both sides, and each row's grant, resolve flag and remaining (atol 1e-4)
are equal. Under pressure — windows full, or many claims of one launch
contending for the same cells, where the card (a row unresolved only when
its window is full) and the plain version's R rounds leave different rows
unresolved — the kernel's results are held to the table's
invariants instead: no key holds two cells, every claimed cell lies in its
key's window, an unresolved row is denied with remaining 0 and its resolve
flag clear.
"""

import asyncio
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
from distributedratelimiting.redis_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

ATOL = 1e-4
L = 16
R = 4
N = 1 << 20
NOW = 50_000
CAP = 10.0
RATE = 1.0 / 1024.0
LIMIT = 6.0
WINDOW = 1024


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _fps(rng, m):
    return rng.integers(1, 2**32, (m, 2), dtype=np.uint64).astype(np.uint32)


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


def _tables(rng, device, kind, n=N, present=2000):
    """A table with ``present`` keys placed and random state, on the CPU
    and on the card; returns (keys present, (fp, state) cpu, on card)."""
    keys = _fps(rng, present)
    fp = F.init_fp_table(n)
    F.fp_resolve(fp, _t(keys.view(np.int32)), torch.ones(present, dtype=bool),
                 probe_window=L, rounds=R)
    if kind == "bucket":
        cols = (rng.uniform(0, CAP, n).astype(np.float32),
                rng.integers(NOW - 3000, NOW + 50, n).astype(np.int32),
                rng.random(n) < 0.7)
        cls = K.BucketState
    else:
        cols = (rng.integers(0, 4, n).astype(np.float32),
                rng.integers(0, 4, n).astype(np.float32),
                rng.integers(NOW // WINDOW - 3, NOW // WINDOW + 1,
                             n).astype(np.int32),
                rng.random(n) < 0.7)
        cls = K.WindowState
    # An empty cell holds no state (claims and sweeps keep it so): a new
    # key's cell, which may differ between the two sides, starts clean.
    empty = ~(fp != 0).any(1).numpy()
    for c in cols:
        c[empty] = 0
    cpu = (fp, cls(*(torch.tensor(c) for c in cols)))
    dev = (fp.to(device), cls(*(torch.tensor(c, device=device)
                               for c in cols)))
    return keys, cpu, dev


def _draw(rng, keys, rows, dist):
    """Rows of keys: half present, half new; Zipf or distinct."""
    half = min(rows // 2, len(keys))
    pool = np.concatenate([keys[:half], _fps(rng, rows - half)])
    if dist == "distinct":
        return pool[rng.permutation(len(pool))[:rows]]
    return pool[np.minimum(rng.zipf(1.2, rows) - 1, len(pool) - 1)]


def _same_by_key(cpu, dev, keys, n_shards=1):
    """Each key present in both tables or in neither, its state equal."""
    fp_c = cpu[0].numpy().view(np.uint32)
    fp_d = dev[0].cpu().numpy().view(np.uint32)
    F.check_table_np(fp_d, L, n_shards)
    sc = F.find_np(fp_c, keys, L, n_shards)
    sd = F.find_np(fp_d, keys, L, n_shards)
    np.testing.assert_array_equal(sc >= 0, sd >= 0)
    hit = sc >= 0
    for a, b in zip(cpu[1], dev[1]):
        a, b = a.numpy()[sc[hit]], b.cpu().numpy()[sd[hit]]
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
        else:
            np.testing.assert_array_equal(b, a)
    assert ((fp_c != 0).any(1)).sum() == ((fp_d != 0).any(1)).sum()


def _decide(kind, table, fused, nows, with_remaining):
    fp, st = table
    if kind == "bucket":
        return ck.fp_acquire_scan(fp, st, fused, nows, CAP, RATE,
                                  probe_window=L, rounds=R,
                                  with_remaining=with_remaining)
    return ck.fp_window_scan(fp, st, fused, nows, LIMIT, WINDOW,
                             interpolate=kind == "sliding", probe_window=L,
                             rounds=R, with_remaining=with_remaining)


@pytest.mark.parametrize("kind", ["bucket", "sliding", "fixed"])
@pytest.mark.parametrize("with_remaining", [True, False])
@pytest.mark.parametrize("k,b", [(1, 8), (1, 64), (1, 4096), (8, 4096)])
@pytest.mark.parametrize("dist", ["distinct", "zipf"])
def test_fp_decide_matches_plain(cuda_device, kind, with_remaining, k, b,
                                 dist):
    rng = np.random.default_rng(k * b + len(kind))
    keys, cpu, dev = _tables(rng, cuda_device,
                             "bucket" if kind == "bucket" else "window")
    rows = _draw(rng, keys, k * b, dist)
    counts = rng.integers(0, 4, k * b)
    counts[rng.random(k * b) < 0.05] = -1  # padding rows
    fused = F.pack_fp12(rows, np.zeros(0)).reshape(k, b, 3)
    fused[..., 2] = counts.reshape(k, b).astype(np.int64).astype(np.uint32)
    fused_t = _t(fused.view(np.int32))
    nows = _t(np.arange(k, dtype=np.int32) * 37 + NOW)
    want = _decide(kind, cpu, fused_t, nows, with_remaining)
    before = ck.launches["fp_decide" if kind == "bucket"
                         else "fp_window_decide"]
    got = _decide(kind, dev, fused_t.to(cuda_device), nows.to(cuda_device),
                  with_remaining)
    torch.cuda.synchronize()
    assert ck.launches["fp_decide" if kind == "bucket"
                       else "fp_window_decide"] == before + 1
    got, want = got.cpu().numpy(), want.numpy()
    if with_remaining:
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=ATOL)
    else:
        assert got.shape == (k, 2, b // 8)
        np.testing.assert_array_equal(got, want)
    _same_by_key(cpu, dev, np.concatenate([keys, rows]))


def test_fp_decide_under_pressure_keeps_invariants(cuda_device):
    rng = np.random.default_rng(5)
    n, lw = 64, 8
    fp = torch.zeros((n, 2), dtype=torch.int32, device=cuda_device)
    st = K.init_bucket_state(n, cuda_device)
    rows = _fps(rng, 200)
    fused = _t(F.pack_fp12(rows, np.ones(200, np.int64)).view(
        np.int32)).reshape(1, 200, 3).to(cuda_device)
    out = ck.fp_acquire_scan(fp, st, fused, _t(np.array([NOW], np.int32)).to(
        cuda_device), CAP, RATE, probe_window=lw, rounds=R).cpu().numpy()
    code = out[0, 0].astype(np.int32)
    res = (code & 2) > 0
    assert 0 < res.sum() <= n
    assert not (code[~res] & 1).any() and (out[0, 1][~res] == 0).all()
    fp_np = fp.cpu().numpy().view(np.uint32)
    assert F.check_table_np(fp_np, lw) == res.sum()
    found = F.find_np(fp_np, rows, lw)
    assert (found[res] >= 0).all()


@pytest.mark.parametrize("b", [8, 4096])
def test_fp_debit_matches_plain(cuda_device, b):
    rng = np.random.default_rng(b)
    keys, cpu, dev = _tables(rng, cuda_device, "bucket")
    rows = _draw(rng, keys, b, "zipf")
    amounts = rng.integers(-3, 5, b).astype(np.float32)
    n = b - 3
    packed = np.zeros((4, b), np.int32)
    packed[0, n:] = -1
    packed[1] = amounts.view(np.int32)
    packed[2] = NOW
    packed[3, :n] = F.fp_prefix_float(rows[:n], amounts[:n]).view(np.int32)
    kp = _t(rows.view(np.int32))
    want = ck.fp_debit(*cpu, kp, _t(packed.copy()), CAP, RATE,
                       probe_window=L, rounds=R).numpy()
    got = ck.fp_debit(*dev, kp.to(cuda_device), _t(packed).to(cuda_device),
                      CAP, RATE, probe_window=L, rounds=R).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _same_by_key(cpu, dev, np.concatenate([keys, rows]))


def test_fp_peek_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    keys, cpu, dev = _tables(rng, cuda_device, "bucket")
    rows = _draw(rng, keys, 4096, "distinct")
    valid = rng.random(4096) < 0.9
    kp, v = _t(rows.view(np.int32)), _t(valid)
    want = ck.fp_peek(*cpu, kp, v, NOW, CAP, RATE, probe_window=L).numpy()
    got = ck.fp_peek(*dev, kp.to(cuda_device), v.to(cuda_device), NOW, CAP,
                     RATE, probe_window=L).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    _same_by_key(cpu, dev, keys)  # a peek claims nothing


@pytest.mark.parametrize("kind", ["bucket", "window"])
def test_fp_sweep_matches_plain(cuda_device, kind):
    rng = np.random.default_rng(11)
    keys, cpu, dev = _tables(rng, cuda_device, kind)
    if kind == "bucket":
        now = NOW + 8 * 1024
        want = ck.fp_sweep_expired(*cpu, now, CAP, RATE)
        got = ck.fp_sweep_expired(*dev, now, CAP, RATE)
    else:
        now = NOW + WINDOW
        want = ck.fp_sweep_windows(*cpu, now, WINDOW)
        got = ck.fp_sweep_windows(*dev, now, WINDOW)
    assert int(got.cpu()[0]) == int(want[0]) > 0
    np.testing.assert_array_equal(dev[0].cpu().numpy(), cpu[0].numpy())
    for a, b in zip(cpu[1], dev[1]):
        np.testing.assert_array_equal(b.cpu().numpy(), a.numpy())


@pytest.mark.parametrize("kind", ["bucket", "window"])
def test_fp_migrate_matches_plain(cuda_device, kind):
    rng = np.random.default_rng(13)
    keys, old, _ = _tables(rng, cuda_device, kind, n=4096, present=2000)
    fp_old = old[0].numpy().view(np.uint32)
    cells = np.nonzero((fp_old != 0).any(1))[0]
    kp = _t(fp_old[cells].view(np.int32))
    cols = [t[torch.from_numpy(cells)] for t in old[1]]
    valid = torch.ones(len(cells), dtype=torch.bool)
    cls = type(old[1])
    new_c = (F.init_fp_table(8192), cls(*(torch.zeros_like(t).repeat(2)
                                          for t in old[1])))
    new_d = tuple(x.to(cuda_device) if isinstance(x, torch.Tensor)
                  else cls(*(t.to(cuda_device) for t in x)) for x in new_c)
    want = ck.fp_migrate(*new_c, kp, cols, valid, probe_window=L, rounds=R)
    got = ck.fp_migrate(*new_d, kp.to(cuda_device),
                        [c.to(cuda_device) for c in cols],
                        valid.to(cuda_device), probe_window=L, rounds=R)
    assert want.all() and got.cpu().all()
    _same_by_key(new_c, new_d, keys)


def _region_tables(rng, device, kind, n, present, n_shards):
    """``_tables`` with the keys placed in ``n_shards`` shard regions."""
    keys = _fps(rng, present)
    fp = F.init_fp_table(n)
    F.fp_resolve(fp, _t(keys.view(np.int32)), torch.ones(present, dtype=bool),
                 probe_window=L, rounds=R, n_shards=n_shards)
    live = (fp != 0).any(1).numpy()
    if kind == "bucket":
        cols = [rng.uniform(0, CAP, n).astype(np.float32),
                rng.integers(NOW - 3000, NOW + 50, n).astype(np.int32),
                rng.random(n) < 0.7]
        cls = K.BucketState
    else:
        cols = [rng.integers(0, 4, n).astype(np.float32),
                rng.integers(0, 4, n).astype(np.float32),
                rng.integers(NOW // WINDOW - 3, NOW // WINDOW + 1,
                             n).astype(np.int32),
                rng.random(n) < 0.7]
        cls = K.WindowState
    for c in cols:
        c[~live] = 0
    cpu = (fp, cls(*(torch.tensor(c) for c in cols)))
    return keys[F.find_np(fp.numpy().view(np.uint32), keys, L,
                          n_shards) >= 0], cpu, _copy(cpu, device)


def _copy(table, device=None):
    fp, st = table
    return (fp.to(device) if device else fp.clone(),
            type(st)(*(t.to(device) if device else t.clone() for t in st)))


def _passes(new, old, n_shards):
    """The stores' growth loop (``fp_store.migrate_passes``) into one new
    table. Returns (unplaced rows, rows left, launches)."""
    from distributedratelimiting.redis_tpu_torch.runtime.fp_store import (
        migrate_passes,
    )

    before = dict(ck.launches)
    left, source = migrate_passes(*new, *old, probe_window=L, rounds=R,
                                  n_shards=n_shards, chunk=4096)
    spent = sum(ck.launches[k] - before[k] for k in ck.launches)
    return source, left, spent


@pytest.mark.parametrize("kind", ["bucket", "window"])
@pytest.mark.parametrize("n_shards", [1, 8])
def test_fp_migrate_table_matches_plain(cuda_device, kind, n_shards):
    """Growth's table form: a 2^16-slot table of 40,000 entries into 2^17
    slots, on the card (one launch, every entry placed) and in the plain
    version (JAX's chunks), held by key and by the invariants."""
    rng = np.random.default_rng(21 + n_shards)
    keys, old_c, old_d = _region_tables(rng, cuda_device, kind, 1 << 16,
                                        40_000, n_shards)
    cls = type(old_c[1])
    new_c = (F.init_fp_table(1 << 17),
             cls(*(torch.zeros(1 << 17, dtype=t.dtype) for t in old_c[1])))
    new_d = _copy(new_c, cuda_device)
    _, left_c, spent_c = _passes(new_c, old_c, n_shards)
    _, left_d, spent_d = _passes(new_d, old_d, n_shards)
    assert left_c == left_d == 0 and spent_c == 0
    assert spent_d == 1
    _same_by_key(new_c, new_d, keys, n_shards)
    assert F.check_table_np(new_d[0].cpu().numpy().view(np.uint32), L,
                            n_shards) == len(keys)


@pytest.mark.parametrize("n_shards", [1, 8])
def test_fp_migrate_table_unplaced_rows_have_full_windows(cuda_device,
                                                          n_shards):
    """Re-placing a dense table at its own size: the card leaves a row
    unplaced only when its window is full; the unplaced list holds exactly
    the entries the new table lacks, each once; a second pass over the
    list places none (the stores' "stuck" rule)."""
    rng = np.random.default_rng(31 + n_shards)
    n = 1 << 14
    keys, old_c, old_d = _region_tables(rng, cuda_device, "bucket", n,
                                        int(0.95 * n), n_shards)
    new_d = (F.init_fp_table(n, cuda_device),
             K.init_bucket_state(n, cuda_device))
    source, left, spent = _passes(new_d, old_d, n_shards)
    fp_new = new_d[0].cpu().numpy().view(np.uint32)
    fp_old = old_c[0].numpy().view(np.uint32)
    assert len(source) == left
    missing = source.cpu().numpy()
    assert len(np.unique(missing)) == left
    assert spent == (2 if left else 1)
    if left:
        lost = fp_old[missing]
        assert (F.find_np(fp_new, lost, L, n_shards) < 0).all()
        win = fp_new.view(np.uint64).reshape(-1)[
            F.base_index_np(lost, n, L, n_shards)[:, None]
            + np.arange(L)[None, :]]
        assert (win != 0).all()
    placed = keys[F.find_np(fp_new, keys, L, n_shards) >= 0]
    assert len(placed) + left == len(keys)
    assert F.check_table_np(fp_new, L, n_shards) == len(placed)
    sc = F.find_np(fp_old, placed, L, n_shards)
    sd = F.find_np(fp_new, placed, L, n_shards)
    for a, b in zip(old_c[1], new_d[1]):
        np.testing.assert_array_equal(b.cpu().numpy()[sd], a.numpy()[sc])


def test_fp_store_on_card_equals_cpu_store(cuda_device):
    """The store end to end: the card's fingerprint store against the same
    store on the CPU (plain versions). Below the load limit flushes, bulks,
    debits and peeks are equal call for call; a flood of new keys then
    grows both tables (which rows end unresolved is the atomics' choice:
    on each side every flood row is granted or was unresolved), and the
    first keys' balances survive the growth equal."""
    from distributedratelimiting.redis_tpu_torch.runtime.clock import (
        ManualClock,
    )
    from distributedratelimiting.redis_tpu_torch.runtime.fp_store import (
        FingerprintBucketStore,
    )

    async def drive(device):
        st = FingerprintBucketStore(n_slots=1 << 16, device=device,
                                    clock=ManualClock(NOW))
        rng = np.random.default_rng(21)
        keys = [f"k{i}" for i in range(1000)]
        exact = []
        for _ in range(3):
            ks = [keys[i] for i in rng.integers(0, len(keys), 3000)]
            r = await st.acquire_many(ks, [1] * 3000, 5.0, 1.0)
            exact += [r.granted, r.remaining]
            r = await st.acquire_many(ks[:2000], [2] * 2000, 5.0, 1.0,
                                      with_remaining=False)
            exact.append(r.granted)
            rs = await asyncio.gather(*(st.acquire(k, 1, 5.0, 1.0)
                                        for k in ks[:64]))
            exact.append(np.array([x.remaining for x in rs]))
            st.clock.advance_ticks(700)
            exact += list(await st.debit_many(ks[:50], [1.0] * 50, 5.0, 1.0))
            exact.append(np.array([st.peek_blocking(k, 5.0, 1.0)
                                   for k in ks[:50]]))
        assert st.metrics.pregrows == 0 and st.metrics.fp_unresolved == 0
        flood = [f"f{i}" for i in range(60_000)]
        for _ in range(3):
            before = st.metrics.fp_unresolved
            r = await st.acquire_many(flood, [1] * len(flood), 5.0, 1.0)
            # cap 5, count 1, three rounds: a flood row is denied only
            # when it was unresolved.
            assert (int(r.granted.sum()) + st.metrics.fp_unresolved
                    - before) == len(flood)
        peeks = np.array([st.peek_blocking(k, 5.0, 1.0) for k in keys])
        table = st._table(5.0, 1.0)
        F.check_table_np(table.fp.cpu().numpy().view(np.uint32),
                         table.probe_window)
        grows = st.metrics.pregrows
        await st.aclose()
        return exact, peeks, grows

    got = asyncio.run(drive(cuda_device))
    want = asyncio.run(drive(torch.device("cpu")))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=0,
                                   atol=ATOL)
    assert got[2] >= 1 and want[2] >= 1
    np.testing.assert_array_equal(got[1], want[1])


def _planes(out):
    """A bits result ``u8[K, 2, B/8]`` → (grants, resolved), bool[K * B]."""
    bits = np.unpackbits(out, axis=-1, bitorder="little").astype(bool)
    return bits[:, 0].reshape(-1), bits[:, 1].reshape(-1)


def _plain_over(kind, table, slots, counts, live, now):
    """The plain decision of one batch over given cells (the card's):
    ``acquire_core`` / ``window_acquire_core`` with JAX's same-batch
    prefix, on ``table`` (updated in place). Returns (granted, remaining)."""
    args = (table[1], _t(slots.astype(np.int32)), _t(counts.astype(np.int32)),
            _t(live), now)
    if kind == "bucket":
        _, g, r = K.acquire_core(*args, CAP, RATE, handle_duplicates=True)
    else:
        _, g, r = K.window_acquire_core(*args, LIMIT, WINDOW,
                                        handle_duplicates=True,
                                        interpolate=kind == "sliding")
    return g.numpy(), r.numpy()


@pytest.mark.parametrize("kind", ["bucket", "sliding", "fixed"])
@pytest.mark.parametrize("b,with_remaining", [
    (8, True), (8, False), (32, True), (32, False), (33, True), (64, True),
    (64, False), (4096, True), (4096, False)])
def test_fp_flush_form_equals_plain_over_its_cells(cuda_device, kind, b,
                                                   with_remaining):
    """K = 1 (the flush form: a warp up to 32 rows, blocks above) under
    window pressure, keys repeated within a warp and across blocks, padding
    rows: each row's outcome is its key's (a key present in the card's
    table after the launch, or a full window: unresolved, code 0 or 1 with
    no +2 and denied), and the card's grants, remaining and state equal the
    plain decision over the card's cells with JAX's same-batch prefix."""
    rng = np.random.default_rng(100 * b + len(kind) + with_remaining)
    n = max(64, b)
    keys, cpu, dev = _tables(rng, cuda_device,
                             "bucket" if kind == "bucket" else "window",
                             n=n, present=n)
    # A table of n cells offered n keys (R claim rounds leave a few cells
    # free), then more new keys than free cells.
    placed = keys[F.find_np(cpu[0].numpy().view(np.uint32), keys, L) >= 0]
    pool = np.concatenate([placed[rng.permutation(len(placed))[
        :max(2, b // 8)]], _fps(rng, max(2, b // 4))])
    rows = pool[rng.integers(0, len(pool), b)]
    counts = rng.integers(0, 4, b)
    counts[rng.random(b) < 0.1] = -1  # padding rows
    fused = F.pack_fp12(rows, np.zeros(0))
    fused[:, 2] = counts.astype(np.int64).astype(np.uint32)
    before = ck.launches["fp_decide" if kind == "bucket"
                         else "fp_window_decide"]
    out = _decide(kind, dev, _t(fused.view(np.int32)).reshape(1, b, 3).to(
        cuda_device), _t(np.array([NOW], np.int32)).to(cuda_device),
        with_remaining).cpu().numpy()
    assert ck.launches["fp_decide" if kind == "bucket"
                       else "fp_window_decide"] == before + 1
    if with_remaining:
        code = out[0, 0].astype(np.int32)
        got_g, got_res, got_rem = (code & 1) > 0, (code & 2) > 0, out[0, 1]
        assert set(np.unique(code)) <= {0, 1, 2, 3}
    else:
        got_g, got_res = _planes(out)
        got_rem = None
    fp_d = dev[0].cpu().numpy().view(np.uint32)
    F.check_table_np(fp_d, L)
    valid = counts >= 0
    slot = F.find_np(fp_d, rows, L)
    np.testing.assert_array_equal(got_res, ~valid | (slot >= 0))
    lost = valid & ~got_res
    if b >= 64:
        assert lost.any() and (valid & got_res).any(), "no window pressure"
    cells = fp_d.view(np.uint64).reshape(-1)
    win = cells[F.base_index_np(rows[lost], n, L)[:, None]
                + np.arange(L)[None, :]]
    assert (win != 0).all(), "an unresolved row beside a free cell"
    live = valid & got_res
    want_g, want_rem = _plain_over(kind, cpu, np.where(live, slot, -1),
                                   np.maximum(counts, 0), live, NOW)
    np.testing.assert_array_equal(got_g, want_g)
    assert not got_g[~live].any()
    if got_rem is not None:
        np.testing.assert_allclose(got_rem, want_rem, rtol=0, atol=ATOL)
    for a, d in zip(cpu[1], dev[1]):
        a, d = a.numpy(), d.cpu().numpy()
        if a.dtype == np.float32:
            np.testing.assert_allclose(d, a, rtol=0, atol=ATOL)
        else:
            np.testing.assert_array_equal(d, a)


@pytest.mark.parametrize("kind,k,b,with_remaining", [
    ("bucket", 8, 4096, True), ("bucket", 1, 4096, True),
    ("bucket", 8, 4096, False), ("sliding", 8, 4096, True),
    ("fixed", 1, 512, False)])
def test_fp_decide_shard_regions_with_counts(cuda_device, kind, k, b,
                                             with_remaining):
    """The mesh's launch: every shard region's rows in one decision (8
    regions), against the plain version by key, with each row's count
    returned for the global tier (K > 1: the scan's operand row; K = 1:
    a tensor of its own)."""
    rng = np.random.default_rng(7 * k + b + len(kind))
    keys, cpu, dev = _region_tables(
        rng, cuda_device, "bucket" if kind == "bucket" else "window", N,
        20_000, 8)
    rows = _draw(rng, keys, k * b, "zipf")
    counts = rng.integers(0, 4, k * b)
    counts[rng.random(k * b) < 0.05] = -1
    fused = F.pack_fp12(rows, np.zeros(0)).reshape(k, b, 3)
    fused[..., 2] = counts.reshape(k, b).astype(np.int64).astype(np.uint32)
    fused_t = _t(fused.view(np.int32))
    nows = _t(np.arange(k, dtype=np.int32) * 37 + NOW)

    def call(table, f, nw):
        if kind == "bucket":
            return ck.fp_acquire_scan(*table, f, nw, CAP, RATE,
                                      probe_window=L, rounds=R, n_shards=8,
                                      with_remaining=with_remaining,
                                      return_counts=True)
        return (ck.fp_window_scan(*table, f, nw, LIMIT, WINDOW,
                                  interpolate=kind == "sliding",
                                  probe_window=L, rounds=R, n_shards=8,
                                  with_remaining=with_remaining), None)
    want, want_c = call(cpu, fused_t, nows)
    got, got_c = call(dev, fused_t.to(cuda_device), nows.to(cuda_device))
    got, want = got.cpu().numpy(), want.numpy()
    if with_remaining:
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, want)
    if want_c is not None:
        assert tuple(got_c.shape) == (k, b)
        np.testing.assert_array_equal(got_c.cpu().numpy(), want_c.numpy())
        np.testing.assert_array_equal(want_c.numpy().reshape(-1),
                                      np.maximum(counts, 0))
    _same_by_key(cpu, dev, np.concatenate([keys, rows]), 8)


def _launch_traces():
    """Each decision's kernels from a profiler trace, on the card: the
    flush form at K = 1 (8, 64 and 4,096 rows) and the chunk form at 8 x
    4,096, f32 and bits, buckets and windows. Returns ``[(kind, k, b,
    with_remaining, [kernel names])]``."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    traces = []
    for kind in ("bucket", "sliding"):
        keys, _, table = _tables(rng, dev,
                                 "bucket" if kind == "bucket" else "window")
        for k, b in ((1, 8), (1, 64), (1, 4096), (8, 4096)):
            rows = _draw(rng, keys, k * b, "zipf")
            fused = _t(F.pack_fp12(rows, rng.integers(0, 4, k * b)).view(
                np.int32)).reshape(k, b, 3).to(dev)
            nows = _t(np.full(k, NOW, np.int32)).to(dev)
            for with_remaining in (True, False):
                _decide(kind, table, fused, nows, with_remaining)  # built
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    _decide(kind, table, fused, nows, with_remaining)
                    torch.cuda.synchronize()
                traces.append((kind, k, b, with_remaining, [
                    e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]))
    return traces


def test_fp_decide_kernel_launches(cuda_device):
    """A profiler trace of each decision holds ONE kernel at K = 1 (the
    flush form) and two at 8 x 4,096 (the resolve, then the scan's
    fingerprint form). The traces are taken in a process of their own: a
    torch.profiler session late in a long process may record no kernel at
    all (ROADMAP C1), which would say nothing of the launches."""
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent), str(here), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_fp_cuda as t; "
         "print(json.dumps(t._launch_traces()))"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    traces = json.loads(proc.stdout.splitlines()[-1])
    assert len(traces) == 16
    for kind, k, b, with_remaining, kernels in traces:
        want = ["resolve_kernel", "scan_kernel"] if k > 1 else ["fp_flush_"]
        assert len(kernels) == len(want) and all(
            w in n for w, n in zip(want, kernels)), (
            kind, k, b, with_remaining, kernels)
