"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no CPU mode)
and skip without one. This file imports neither JAX nor the JAX package, so
it runs on a machine without JAX; there, skip the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in ``test_torch_kernels.py``: grants, bits, masks, ``exists``
and ``last_ts`` equal; in the scans remaining and tokens within atol 1e-4
(the scan kernel subtracts each slot's int64 sum once, where the plain
version subtracts row by row). The flush kernels (bucket and window, plain
and grouped) equal their plain versions bit for bit, results and every
state field: whole counts, and each slot's one writer applies the int64 sum
of its consumption once, which equals the plain version's row-by-row float
arithmetic where every partial result is exact. Counter syncs: replies,
period, ``last_ts`` and
``exists`` equal; value equal where slots are distinct, at B <= 32 (the
warp adds a slot's counts in the plain version's order) and on whole
numbers; elsewhere a slot that takes r > 1 adds lies within r spacings of
its float32 value (the kernel rounds each slot's exact sum once, the plain
version each add). Window kernels (sliding and fixed): grants, remaining, masks,
``prev_count``, ``window_idx`` and ``exists`` equal bit for bit;
``curr_count`` too, since the counts are whole numbers below 2^24.

Semaphores: ``sema_packed`` replies and every state field (``active``,
``last_ts``, ``exists``) equal bit for bit (whole counts, int64 prefixes,
one writer per slot); ``sweep_semas`` masks, tile counts and ``exists``
equal. Two-level admission: replies and every state field of both tables
equal bit for bit (whole costs below 2^24: each slot's one writer subtracts
its int64 consumption once, which equals the plain version's row-by-row
subtraction). Debit: with distinct slots, or whole numbers, every reply and state field
equal bit for bit; with repeated slots (fractional and negative amounts, the
host's float prefix) replies, ``last_ts`` and ``exists`` equal, and a
slot's tokens within r float32 spacings of its largest partial sum for r
rounded adds (a slot with one add equal). The sync and the debit are
deterministic: two launches on clones of a table give equal bits.
"""

import asyncio

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import kernels as K

ATOL = 1e-4
CAP = 10.0
N = 4096
B = 512


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _state(seed, device, n=N, now=50_000):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0, CAP, n).astype(np.float32),
              rng.integers(now - 3000, now + 50, n).astype(np.int32),
              rng.random(n) < 0.6)
    return [K.BucketState(*(torch.tensor(a, device=d) for a in arrays))
            for d in ("cpu", device)]


def _operand(seed, rows, b=B, now=50_000):
    rng = np.random.default_rng(seed)
    slots = np.minimum(rng.zipf(1.3, b) - 1, N - 1).astype(np.int32)
    slots[rng.random(b) < 0.1] = -1
    slots[rng.random(b) < 0.05] = N + 3
    counts = rng.integers(0, 4, b).astype(np.int32)
    sizes = rng.integers(1, 6, b).astype(np.int32)
    valid = torch.from_numpy((slots >= 0) & (slots < N))
    demand = counts * sizes if rows == 5 else counts
    prefix = bm.duplicate_prefix(torch.from_numpy(slots),
                                 torch.from_numpy(demand), valid)
    out = [slots, counts, np.full(b, now, np.int32),
           prefix.numpy().astype(np.int32), sizes]
    return torch.from_numpy(np.stack(out[:rows]))


def _assert_same(card, plain, card_out, plain_out):
    np.testing.assert_array_equal(card_out[0].cpu().numpy(),
                                  plain_out[0].cpu().numpy())
    np.testing.assert_allclose(card_out[1].cpu().numpy(),
                               plain_out[1].cpu().numpy(), atol=ATOL, rtol=0)
    _assert_same_state(card, plain)


def _assert_same_state(card, plain):
    np.testing.assert_allclose(card.tokens.cpu().numpy(),
                               plain.tokens.cpu().numpy(), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(card.last_ts.cpu().numpy(),
                                  plain.last_ts.cpu().numpy())
    np.testing.assert_array_equal(card.exists.cpu().numpy(),
                                  plain.exists.cpu().numpy())


def _assert_exact(card, plain, card_out, plain_out):
    """A flush: results and every state field equal bit for bit."""
    np.testing.assert_array_equal(card_out.cpu().numpy(),
                                  plain_out.cpu().numpy())
    for name in plain._fields:
        np.testing.assert_array_equal(getattr(card, name).cpu().numpy(),
                                      getattr(plain, name).cpu().numpy(),
                                      err_msg=name)


#: The flushes' shapes: the warp path (B <= 32) and every block form
#: launch_flush picks (64 x 1 at 33-64 rows, 256 x 1 at 65-256, both one
#: block; 1024 x 1 at 257-1024, 1024 x 2 at 1025-2048 and 1024 x 4 at
#: 2049-4096, spread over blocks). 4096 is the widest flush.
FLUSH_SIZES = [B, 1, 8, 12, 32, 33, 64, 128, 256, 257, 2048, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("b", FLUSH_SIZES)
@pytest.mark.parametrize("rows,wrapper", [(4, ck.acquire_packed),
                                          (5, ck.acquire_grouped)])
def test_acquire_kernels_match_plain(cuda_device, rows, wrapper, b):
    plain, card = _state(1, cuda_device)
    op = _operand(2, rows, b)
    before = dict(ck.launches)
    want = wrapper(plain, op, CAP, 0.013)
    got = wrapper(card, op.to(cuda_device), CAP, 0.013)
    torch.cuda.synchronize()
    _assert_exact(card, plain, got, want)
    name = "acquire_packed" if rows == 4 else "acquire_grouped"
    assert ck.launches[name] == before[name] + 1  # one launch per call
    assert sum(ck.launches.values()) == sum(before.values()) + 1


@pytest.mark.cuda
def test_flush_past_4096_rows_raises(cuda_device):
    """4096 rows is the widest flush: each of the four flush wrappers raises
    at 4,097 rows, and nothing is launched."""
    assert ck.FLUSH_MAX_BATCH == ck.WINDOW_FLUSH_MAX_BATCH == 4096
    _, buckets = _state(1, cuda_device)
    _, windows = _windows(7, cuda_device)
    before = dict(ck.launches)
    for rows, wrapper, table, args in (
            (4, ck.acquire_packed, buckets, (CAP, 0.013)),
            (5, ck.acquire_grouped, buckets, (CAP, 0.013)),
            (4, ck.window_packed, windows, (W_LIMIT, W_TICKS)),
            (5, ck.window_grouped, windows, (W_LIMIT, W_TICKS))):
        op = _operand(2, rows, 4097).to(cuda_device)
        with pytest.raises(ValueError, match="at most 4096 rows"):
            wrapper(table, op, *args)
    torch.cuda.synchronize()
    assert ck.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bucket", "window"])
@pytest.mark.parametrize("rows", [1, 11, 64, 4096])
def test_bulk_chunk_of_one_batch_is_one_flush(cuda_device, kind, rows):
    """A card store decides a bulk call of at most ``max_batch`` rows as ONE
    flush of its rows (no scan), and its grants, remaining and later state
    equal a CPU store's on the same clock (whole counts: the flush equals
    its plain version bit for bit)."""
    from distributedratelimiting.redis_tpu_torch import (
        DeviceBucketStore,
        ManualClock,
    )

    rng = np.random.default_rng(rows)
    keys = [f"k{i}" for i in range(rows)]
    for i in rng.choice(rows, rows // 6, replace=False):
        keys[i] = keys[int(rng.integers(0, rows))]
    results = []
    for device in ("cpu", cuda_device):
        store = DeviceBucketStore(device=device, clock=ManualClock(10_000),
                                  n_slots=2**14)
        before = dict(ck.launches)
        out = []
        for r in range(2):
            counts = np.random.default_rng([rows, r]).integers(1, 41, rows)
            if kind == "bucket":
                res = store.acquire_many_blocking(keys, counts, 40.0, 64.0)
            else:
                res = store.window_acquire_many_blocking(keys, counts, 40.0,
                                                         1.0)
            out.append((res.granted.tolist(), res.remaining.tolist()))
            store.clock.advance_ticks(300)
        table = (store._tables if kind == "bucket" else store._wtables)
        out.append([[t.cpu().numpy().tolist() for t in tab.state]
                    for tab in table.values()])
        results.append(out)
        if device != "cpu":
            flush = "acquire_packed" if kind == "bucket" else "window_packed"
            scan = "acquire_scan" if kind == "bucket" else "window_scan"
            assert ck.launches[flush] == before[flush] + 2
            assert ck.launches[scan] == before[scan]
            pad = max(8, 1 << (rows - 1).bit_length())
            assert store.metrics.rows_processed == 2 * pad
    assert results[0] == results[1]
    granted = results[0][0][0] + results[0][1][0]
    if rows >= 11:
        assert 0 < sum(granted) < len(granted)


def _scan_operand(rng, k, b, n, fused, distinct=False):
    """Zipf slots (duplicates within and across batches), or slots distinct
    within each batch (the kernel skips its sort); padding and out-of-range
    rows; the fused u8 operand or i32 counts up to 1000."""
    if distinct:
        slots = np.stack([rng.permutation(n)[:b] for _ in range(k)])
    else:
        slots = np.minimum(rng.zipf(1.3, (k, b)) - 1, n - 1)
    slots = slots.astype(np.int32)
    slots[rng.random((k, b)) < 0.02] = -1
    slots[rng.random((k, b)) < 0.01] = n + 3
    if fused:
        return torch.from_numpy(K.pack_compact5(
            slots, rng.integers(0, 4, (k, b)).astype(np.uint8)))
    counts = rng.integers(0, 1001, (k, b)).astype(np.int32)
    return torch.from_numpy(np.stack([slots, counts]))


def _nows(k):
    return torch.tensor([50_000 + 300 * (3 * i // k) for i in range(k)],
                        dtype=torch.int32)


def _scan_both(plain, card, operand, nows, cap, with_remaining):
    """The scan wrapper on the card, its plain version on the CPU; one
    launch per call whatever K is."""
    before = dict(ck.launches)
    want = ck.acquire_scan_packed(plain, operand, nows, cap, 0.013,
                                  with_remaining=with_remaining)
    got = ck.acquire_scan_packed(card, operand.to(card.tokens.device),
                                 nows.to(card.tokens.device), cap, 0.013,
                                 with_remaining=with_remaining)
    torch.cuda.synchronize()
    assert ck.launches["acquire_scan"] == before["acquire_scan"] + 1
    assert sum(ck.launches.values()) == sum(before.values()) + 1
    return got, want


@pytest.mark.cuda
# The bulk copy; and B % 16 != 0 with K * B / 8 not a whole number of words.
@pytest.mark.parametrize("k,b", [(32, B), (31, 104)])
@pytest.mark.parametrize("fused,with_remaining,distinct", [
    (True, True, False), (True, False, False), (False, True, False),
    (True, False, True), (False, True, True)])
def test_scan_lane_matches_plain(cuda_device, fused, with_remaining, k, b,
                                 distinct):
    """K batches in one launch against the plain per-batch loop."""
    cap = CAP if fused else 1000.0  # balances < 1024: one ulp < ATOL
    plain, card = _state(3, cuda_device)
    for st in (plain, card):
        st.tokens.mul_(cap / CAP)
    operand = _scan_operand(np.random.default_rng(4), k, b, N, fused,
                            distinct)
    got, want = _scan_both(plain, card, operand, _nows(k), cap,
                           with_remaining)
    if with_remaining:
        _assert_same(card, plain, got.transpose(0, 1), want.transpose(0, 1))
        grants = want[:, 0]
    else:
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        _assert_same_state(card, plain)
        grants = torch.from_numpy(np.unpackbits(want.numpy(), axis=-1,
                                                bitorder="little"))
    assert 0 < int(grants.sum()) < grants.numel()


@pytest.mark.cuda
def test_scan_prefix_exact_past_2_24(cuda_device):
    """test_duplicate_prefix_integer_exact_past_2_24's inputs through the
    kernel: six asks of 2^22 + 1 on one fresh slot, so its running demand
    passes 2^24. Grants and remaining equal the plain version's int64
    prefix; the one writer leaves tokens = capacity - the int64 sum of the
    consumption, exactly (a serial float subtraction would round)."""
    cap = float(2**25)
    plain, card = _state(5, cuda_device)
    for st in (plain, card):
        st.exists[0] = False
    slots = np.full((1, 8), -1, np.int32)
    counts = np.zeros((1, 8), np.int32)
    slots[0, :6], counts[0, :6] = 0, 2**22 + 1
    operand = torch.from_numpy(np.stack([slots, counts]))
    got, want = _scan_both(plain, card, operand, _nows(1), cap, True)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert got[0, 0, :6].all()
    assert card.tokens[0].item() == cap - 6 * (2**22 + 1)


@pytest.mark.cuda
def test_scan_after_grow_matches_plain(cuda_device):
    """A table of N = 2^24 + 12,345 slots, as a grown or restored table may
    be: the slots past 2^24 need the sort's 25th bit, and the slots past
    the old size are fresh."""
    n = 2**24 + 12_345
    rng = np.random.default_rng(6)
    old = 2**24
    arrays = (np.zeros(n, np.float32), np.zeros(n, np.int32),
              np.zeros(n, bool))
    arrays[0][:old] = rng.uniform(0, CAP, old)
    arrays[1][:old] = rng.integers(47_000, 50_050, old)
    arrays[2][:old] = rng.random(old) < 0.6
    card = K.BucketState(*(torch.tensor(a, device=cuda_device)
                           for a in arrays))
    plain = K.BucketState(*(t.clone() for t in card))  # plain, on the card
    slots = np.minimum(rng.zipf(1.3, (4, 4096)) - 1, n - 1).astype(np.int32)
    top = rng.random(slots.shape) < 0.5  # half the rows near the top
    slots[top] = n - 1 - (rng.zipf(1.3, int(top.sum())) - 1) % 20_000
    slots[rng.random(slots.shape) < 0.02] = -1
    operand = torch.from_numpy(K.pack_compact5(
        slots, rng.integers(0, 4, slots.shape).astype(np.uint8)))
    nows = _nows(4).to(cuda_device)
    before = ck.launches["acquire_scan"]
    got = ck.acquire_scan_packed(card, operand.to(cuda_device), nows, CAP,
                                 0.013, with_remaining=False)
    _, want = K.acquire_scan_fused_bits(plain, operand.to(cuda_device), nows,
                                        CAP, 0.013)
    torch.cuda.synchronize()
    assert ck.launches["acquire_scan"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    _assert_same_state(card, plain)
    assert bool(card.exists[old:].any())  # the new slots were touched


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.001, 0.0, 1e-9])
def test_sweep_kernel_matches_plain(cuda_device, rate):
    n = 70_000
    rng = np.random.default_rng(5)
    arrays = (rng.uniform(0, 90, n).astype(np.float32),
              rng.integers(0, 1000, n).astype(np.int32), rng.random(n) < 0.5)
    plain, card = [K.BucketState(*(torch.tensor(a, device=d) for a in arrays))
                   for d in ("cpu", cuda_device)]
    want = ck.sweep_expired(plain, 2_000_000, 100.0, rate)
    got = ck.sweep_expired(card, 2_000_000, 100.0, rate)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    np.testing.assert_array_equal(card.exists.cpu().numpy(),
                                  plain.exists.numpy())
    if rate < 1e-6:  # the TTL saturates at 2^31 - 1: nothing expires
        assert int(got[1].sum()) == 0


# -- decaying counters --------------------------------------------------------

def _counters(seed, n, device, now=50_000):
    """Half the counters live, timestamps on both sides of ``now``."""
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0, 1000, n).astype(np.float32),
              rng.uniform(0, 5000, n).astype(np.float32),
              rng.integers(now - 3000, now + 200, n).astype(np.int32),
              rng.random(n) < 0.5)
    return [K.CounterState(*(torch.tensor(a, device=d) for a in arrays))
            for d in ("cpu", device)]


def _sync_operand(seed, b, n, distinct, now=50_000):
    rng = np.random.default_rng(seed)
    if distinct:
        slots = rng.choice(n, b, replace=False).astype(np.int32)
    else:
        slots = ((rng.zipf(1.1, b) - 1) % n).astype(np.int32)
    slots[rng.random(b) < 0.02] = -1
    slots[rng.random(b) < 0.01] = n + 5
    counts = rng.uniform(0, 50, b).astype(np.float32)
    return np.stack([slots, counts.view(np.int32), np.full(b, now, np.int32)])


def _assert_counters_same(card, plain, packed, exact):
    for name in ("period", "last_ts", "exists"):
        np.testing.assert_array_equal(getattr(card, name).cpu().numpy(),
                                      getattr(plain, name).cpu().numpy())
    got, want = card.value.cpu().numpy(), plain.value.cpu().numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    # Each slot against its own limit. Slot s is set to its decayed value,
    # then takes r_s adds in atomic order. Decayed values and counts are
    # >= 0, so each add rounds by at most half a spacing of the final value:
    # two orders differ by at most r_s spacings; one add or none is exact.
    slots = packed[0][(packed[0] >= 0) & (packed[0] < len(got))]
    reps = np.bincount(slots, minlength=len(got))
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
    tol = np.where(reps > 1, reps, 0) * np.spacing(mag).astype(np.float64)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bad = np.flatnonzero(err > tol)
    assert not len(bad), (f"{len(bad)} slots past their limit, e.g. slot "
                          f"{bad[0]}: {got[bad[0]]} vs {want[bad[0]]}, "
                          f"{reps[bad[0]]} adds, limit {tol[bad[0]]}")


@pytest.mark.cuda
@pytest.mark.parametrize("distinct", [True, False])
@pytest.mark.parametrize("b", [8, 32, 33, 256, 4096, 4097, 2**17, 2**20])
def test_sync_kernel_matches_plain(cuda_device, b, distinct):
    n = max(2 * b, 64)
    plain, card = _counters(b, n, cuda_device)
    packed = _sync_operand(b + distinct, b, n, distinct)
    op = torch.from_numpy(packed)
    before = ck.launches["sync_counters"]
    got = ck.sync_counters(card, op.to(cuda_device), 3 / 1024)
    want = ck.sync_counters(plain, op, 3 / 1024)
    torch.cuda.synchronize()
    assert ck.launches["sync_counters"] == before + 1  # one launch a call
    # Replies are per row (decayed + own count): bit-exact even with
    # duplicates, padding and out-of-range rows.
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    # A warp (B <= 32) adds a slot's counts in the plain version's order.
    _assert_counters_same(card, plain, packed, exact=distinct or b <= 32)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [33, 4096, 2**17, 2**20])
def test_sync_kernel_exact_sums_with_duplicates(cuda_device, b):
    """Whole-number values and counts, stored ticks on a 1024-tick grid (the
    decay subtracts a whole number): float32 holds every partial sum, so the
    kernel's one rounding of each slot's sum gives the plain value on every
    slot, the hottest included. A count lost or added twice shows here."""
    n, now = max(2 * b, 64), 50_000
    rng = np.random.default_rng(b)
    arrays = (rng.integers(0, 1000, n).astype(np.float32),
              rng.uniform(0, 5000, n).astype(np.float32),
              (now - 1024 * rng.integers(-1, 4, n)).astype(np.int32),
              rng.random(n) < 0.5)
    plain, card = [K.CounterState(*(torch.tensor(a, device=d) for a in arrays))
                   for d in ("cpu", cuda_device)]
    packed = _sync_operand(b, b, n, distinct=False, now=now)
    packed[1] = rng.integers(1, 9, b).astype(np.float32).view(np.int32)
    op = torch.from_numpy(packed)
    got = ck.sync_counters(card, op.to(cuda_device), 1 / 1024)
    want = ck.sync_counters(plain, op, 1 / 1024)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _assert_counters_same(card, plain, packed, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [32, 4096, 2**17])
def test_sync_slot_zero_and_padding_match_plain(cuda_device, b):
    """Slot 0 is a real slot of the batch and the slot every padding and
    out-of-range row reads for its reply: those replies are slot 0's state
    before the launch, bit for bit, in the warp, the spread blocks and the
    slot-major path."""
    n = 2 * b
    plain, card = _counters(b + 1, n, cuda_device)
    packed = _sync_operand(b + 1, b, n, distinct=False)
    rng = np.random.default_rng(b)
    packed[0][rng.random(b) < 0.3] = -1
    packed[0][rng.random(b) < 0.1] = n + 7
    packed[0][rng.random(b) < 0.05] = 0
    packed[0][0] = 0
    op = torch.from_numpy(packed)
    got = ck.sync_counters(card, op.to(cuda_device), 3 / 1024)
    want = ck.sync_counters(plain, op, 3 / 1024)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _assert_counters_same(card, plain, packed, exact=b <= 32)


def _debit_case(b, n, whole, seed, distinct=False):
    """``(state arrays, packed i32[4, B])``: Zipf(1.3) slots (``distinct``:
    distinct ones), 2% padding; whole numbers (balances, a refill of 13 a
    1024-tick step, amounts) or fractional and negative amounts."""
    rng = np.random.default_rng(seed)
    now = 50_000
    if whole:
        arrays = (rng.integers(0, 50, n).astype(np.float32),
                  (now - 1024 * rng.integers(0, 3, n)).astype(np.int32),
                  rng.random(n) < 0.6)
        amounts = rng.integers(-6, 15, b).astype(np.float32)
    else:
        arrays = (rng.uniform(0, CAP, n).astype(np.float32),
                  rng.integers(now - 3000, now + 50, n).astype(np.int32),
                  rng.random(n) < 0.6)
        amounts = rng.uniform(-4, 8, b).astype(np.float32)
    if distinct:
        slots = rng.choice(n, b, replace=False).astype(np.int32)
    else:
        slots = np.minimum(rng.zipf(1.3, b) - 1, n - 1).astype(np.int32)
    slots[rng.random(b) < 0.02] = -1
    t = torch.from_numpy(slots)
    prefix = bm.duplicate_prefix_float(t, torch.from_numpy(amounts), t >= 0)
    return arrays, np.stack([slots, amounts.view(np.int32),
                             np.full(b, now, np.int32),
                             prefix.numpy().view(np.int32)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(33, 66), (4096, 8192), (2**17, 2**18),
                                 (2**20, 2**24)])
def test_debit_whole_number_duplicates_exact_on_card(cuda_device, b, n):
    """Whole balances, a whole refill (13 tokens a 1024-tick step) and whole
    amounts, slots repeated: every partial sum is exact in float32, so each
    slot's tokens equal the plain version's bit for bit, debits and credits
    alike. The last case's table is larger than the L2: the slot-major
    launch walks its words in slot order."""
    arrays, packed = _debit_case(b, n, True, b)
    plain, card = [K.BucketState(*(torch.tensor(a, device=d)
                                   for a in arrays))
                   for d in ("cpu", cuda_device)]
    op = torch.from_numpy(packed)
    want = ck.debit_packed(plain, op, 60.0, 13 / 1024)
    got = ck.debit_packed(card, op.to(cuda_device), 60.0, 13 / 1024)
    torch.cuda.synchronize()
    assert np.bincount(packed[0][packed[0] >= 0]).max() > 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _assert_tables_equal(card, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sync", "debit"])
def test_tally_rows_pass_on_a_large_table_matches_plain(cuda_device, kind):
    """Past 32 table slots a row, the slot-major launch finds each slot's
    first row by the rows, not by walking the table: 8,192 Zipf rows with
    padding on a 2^20-slot table, whole numbers, equal bit for bit; the
    launch after it (on the table the first left) too."""
    b, n = 8192, 2**20
    if kind == "sync":
        plain, card = _counters(5, n, cuda_device)
        packed = _sync_operand(5, b, n, distinct=False)
        rng = np.random.default_rng(5)
        packed[1] = rng.integers(0, 9, b).astype(np.float32).view(np.int32)
        plain.value.copy_(torch.floor(plain.value))
        card.value.copy_(plain.value.to(cuda_device))
        plain.last_ts.copy_(50_000 - 1024 * (plain.last_ts % 3))
        card.last_ts.copy_(plain.last_ts.to(cuda_device))

        def run(st, op):
            return ck.sync_counters(st, op, 1 / 1024)
    else:
        arrays, packed = _debit_case(b, n, True, 5)
        plain, card = [K.BucketState(*(torch.tensor(a, device=d)
                                       for a in arrays))
                       for d in ("cpu", cuda_device)]

        def run(st, op):
            return ck.debit_packed(st, op, 60.0, 13 / 1024)
    op = torch.from_numpy(packed)
    for _ in range(2):
        want = run(plain, op)
        got = run(card, op.to(cuda_device))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        _assert_tables_equal(card, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [32, 4096, 2**17, 2**20])
@pytest.mark.parametrize("kind", ["sync", "debit"])
def test_tally_kernels_are_deterministic(cuda_device, kind, b):
    """Fractional counts and amounts on repeated slots: two launches on
    clones of one table give equal bits, replies and every state field."""
    n = 2 * b
    if kind == "sync":
        arrays = [a.numpy() for a in _counters(b, n, "cpu")[0]]
        packed = _sync_operand(b, b, n, distinct=False)
        cls, call = K.CounterState, lambda st, op: ck.sync_counters(
            st, op, 3 / 1024)
    else:
        arrays, packed = _debit_case(b, n, False, b)
        cls, call = K.BucketState, lambda st, op: ck.debit_packed(
            st, op, CAP, 0.013)
    op = torch.from_numpy(packed).to(cuda_device)
    runs = []
    for _ in range(2):
        st = cls(*(torch.tensor(a, device=cuda_device) for a in arrays))
        out = call(st, op)
        torch.cuda.synchronize()
        runs.append([out.cpu().numpy()] + [t.cpu().numpy() for t in st])
    for other in runs[1:]:
        for a, b_ in zip(runs[0], other):
            np.testing.assert_array_equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("n,distinct", [(2**23, True), (2**28, False)])
@pytest.mark.parametrize("kind", ["sync", "debit"])
def test_tally_one_launch_past_2_22_rows_matches_plain(cuda_device, kind, n,
                                                      distinct):
    """2^22 + 1 rows in one launch, as a store's fleet sync or debit of that
    many keys sends them: distinct slots of a 2^23 table (the direct words)
    and Zipf slots of a 2^28 table (the hash set). Whole numbers: replies
    and every state field equal the plain version's bit for bit."""
    b, now = 2**22 + 1, 50_000
    if kind == "sync":
        rng = np.random.default_rng(b)
        arrays = (rng.integers(0, 1000, n).astype(np.float32),
                  rng.uniform(0, 5000, n).astype(np.float32),
                  (now - 1024 * rng.integers(-1, 4, n)).astype(np.int32),
                  rng.random(n) < 0.5)
        if distinct:
            slots = rng.choice(n, b, replace=False).astype(np.int32)
        else:
            slots = ((rng.zipf(1.1, b) - 1) % n).astype(np.int32)
        slots[rng.random(b) < 0.02] = -1
        slots[rng.random(b) < 0.01] = n + 5
        packed = np.stack([slots, rng.integers(1, 9, b).astype(
            np.float32).view(np.int32), np.full(b, now, np.int32)])
        cls, call = K.CounterState, lambda st, op: ck.sync_counters(
            st, op, 1 / 1024)
    else:
        arrays, packed = _debit_case(b, n, True, b, distinct=distinct)
        cls, call = K.BucketState, lambda st, op: ck.debit_packed(
            st, op, 60.0, 13 / 1024)
    live = packed[0][(packed[0] >= 0) & (packed[0] < n)]
    assert (np.bincount(live).max() > 1) != distinct
    plain, card = [cls(*(torch.tensor(a, device=d) for a in arrays))
                   for d in ("cpu", cuda_device)]
    op = torch.from_numpy(packed)
    want = call(plain, op)
    got = call(card, op.to(cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _assert_tables_equal(card, plain)


@pytest.mark.cuda
def test_sweep_counters_after_grow_matches_plain(cuda_device):
    """A counter table grown from 5,000 to 10,000 slots (not a power of
    two), swept by the store: the mask, tile counts and directory agree
    with the plain version."""
    from distributedratelimiting.redis_tpu_torch import (
        DeviceBucketStore,
        ManualClock,
    )

    clock = ManualClock(1_000)
    store = DeviceBucketStore(device="cuda", counter_slots=5_000, clock=clock)
    keys = [f"c{i}" for i in range(7_000)]
    store.sync_counter_blocking("warm", 1.0, 1.0)
    # 7,000 keys outrun 5,000 slots: no counter has expired, so it grows.
    scores, _ = asyncio.run(store.sync_counters_many(keys, [1.0] * 7_000,
                                                     1.0))
    assert store._counters.value.shape[0] == 10_000 and (scores == 1.0).all()
    clock.advance_seconds(86_400 - 10)
    asyncio.run(store.sync_counters_many(keys[:3000], [1.0] * 3000, 1.0))
    clock.advance_seconds(20)  # the other 4,001 counters pass their TTL
    plain = K.CounterState(*(t.cpu().clone() for t in store._counters))
    want_mask, want_counts = ck.sweep_counters(plain, clock.now_ticks())
    before = ck.launches["sweep_counters"]
    mask, counts = ck.sweep_counters(
        K.CounterState(*(t.clone() for t in store._counters)),
        clock.now_ticks())
    torch.cuda.synchronize()
    assert ck.launches["sweep_counters"] == before + 1
    np.testing.assert_array_equal(mask.cpu().numpy(), want_mask.numpy())
    np.testing.assert_array_equal(counts.cpu().numpy(), want_counts.numpy())
    assert int(counts.sum()) == 4_001
    store.sweep_all()
    assert len(store._counter_dir) == 3_000


#: ``sweep_counters``'s card cases: a tail shorter than a thread's 16 slots,
#: one thread exactly, a table smaller than a tile of 32,768, one tile, a
#: last partial tile, and the approximate path's 2^20 counters and more.
SWEEP_SIZES = [1, 15, 16, 17, 4101, 32768, 2**16 + 3, 2**20 + 7]


def _device_kernels(fn) -> dict:
    """The device activities of one call of ``fn``: name -> launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0.0) > 0}


@pytest.mark.cuda
@pytest.mark.parametrize("n", SWEEP_SIZES)
def test_sweep_counters_is_one_launch_and_matches_plain(cuda_device, n):
    """The mask, ``exists`` and the tile counts equal the plain version's,
    from ONE kernel launch a call (no memset or fill of ``tile_counts``
    beside it); called directly on tile counts filled with garbage, the
    kernel writes every tile. ``last_ts`` spans two days either side of
    the 86400 s TTL."""
    now = 200_000_000
    ttl = 86400 * 1024
    rng = np.random.default_rng(n)
    arrays = (np.zeros(n, np.float32), np.zeros(n, np.float32),
              rng.integers(now - 2 * ttl, now + 300, n).astype(np.int32),
              rng.random(n) < 0.5)
    plain, card, direct = [
        K.CounterState(*(torch.tensor(a, device=d) for a in arrays))
        for d in ("cpu", cuda_device, cuda_device)]
    want_mask, want_counts = ck.sweep_counters(plain, now)
    before = dict(ck.launches)
    got = []
    kernels = _device_kernels(lambda: got.extend(ck.sweep_counters(card,
                                                                   now)))
    assert ck.launches["sweep_counters"] == before["sweep_counters"] + 1
    assert sum(ck.launches.values()) == sum(before.values()) + 1
    assert len(kernels) == 1 and sum(kernels.values()) == 1, kernels
    assert "sweep_counters" in next(iter(kernels)), kernels
    mask, counts = got
    np.testing.assert_array_equal(mask.cpu().numpy(), want_mask.numpy())
    np.testing.assert_array_equal(counts.cpu().numpy(), want_counts.numpy())
    np.testing.assert_array_equal(card.exists.cpu().numpy(),
                                  plain.exists.numpy())
    # The kernel alone, on garbage tile counts.
    counts = torch.full_like(counts, -12345)
    mask = torch.full_like(mask, 7)
    rc = ck._lib("counter").drl_sweep_counters(
        direct.last_ts.data_ptr(), direct.exists.data_ptr(), mask.data_ptr(),
        counts.data_ptr(), n, now, ck.TILE,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    np.testing.assert_array_equal(mask.cpu().numpy(), want_mask.numpy())
    np.testing.assert_array_equal(counts.cpu().numpy(), want_counts.numpy())
    np.testing.assert_array_equal(direct.exists.cpu().numpy(),
                                  plain.exists.numpy())


@pytest.mark.cuda
def test_sweep_counters_unaligned_table_takes_the_scalar_path(cuda_device):
    """Views one slot into their tensors (pointers not 16-byte aligned):
    the kernel's scalar path gives the plain version's answer."""
    now, ttl, n = 200_000_000, 86400 * 1024, 40_000
    rng = np.random.default_rng(5)
    arrays = (np.zeros(n + 1, np.float32), np.zeros(n + 1, np.float32),
              rng.integers(now - 2 * ttl, now + 300, n + 1).astype(np.int32),
              rng.random(n + 1) < 0.5)
    plain, card = [
        K.CounterState(*(torch.tensor(a, device=d)[1:] for a in arrays))
        for d in ("cpu", cuda_device)]
    want_mask, want_counts = ck.sweep_counters(plain, now)
    mask, counts = ck.sweep_counters(card, now)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(mask.cpu().numpy(), want_mask.numpy())
    np.testing.assert_array_equal(counts.cpu().numpy(), want_counts.numpy())
    np.testing.assert_array_equal(card.exists.cpu().numpy(),
                                  plain.exists.numpy())


# -- windows --------------------------------------------------------------------

W_LIMIT = 20.0
W_TICKS = 1000  # not a power of two


def _windows(seed, device, n=N, now=50_000, w=W_TICKS):
    """A window table: whole-number counts, indices one window behind,
    current, two behind, and (a clock behind them) one ahead."""
    rng = np.random.default_rng(seed)
    idx = now // w + rng.choice([-2, -1, 0, 0, 1], n)
    arrays = (rng.integers(0, 25, n).astype(np.float32),
              rng.integers(0, 25, n).astype(np.float32),
              idx.astype(np.int32), rng.random(n) < 0.6)
    return [K.WindowState(*(torch.tensor(a, device=d) for a in arrays))
            for d in ("cpu", device)]


def _assert_windows_same(card, plain):
    for name in K.WindowState._fields:
        np.testing.assert_array_equal(getattr(card, name).cpu().numpy(),
                                      getattr(plain, name).cpu().numpy(),
                                      err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("b", FLUSH_SIZES)
@pytest.mark.parametrize("rows,wrapper", [(4, ck.window_packed),
                                          (5, ck.window_grouped)])
def test_window_flush_kernels_match_plain(cuda_device, rows, wrapper, b,
                                          interpolate):
    plain, card = _windows(7, cuda_device)
    op = _operand(8, rows, b, now=50_377)
    before = dict(ck.launches)
    want = wrapper(plain, op, W_LIMIT, W_TICKS, interpolate=interpolate)
    got = wrapper(card, op.to(cuda_device), W_LIMIT, W_TICKS,
                  interpolate=interpolate)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _assert_windows_same(card, plain)
    name = "window_packed" if rows == 4 else "window_grouped"
    assert ck.launches[name] == before[name] + 1
    assert sum(ck.launches.values()) == sum(before.values()) + 1
    if b >= 32:
        assert 0 < float(want[0].sum()) and float(want[1].max()) > 0


def _one_valid_row(rows, b=8, now=50_000):
    """The server's scalar flush: one request, padded to 8 rows."""
    op = np.zeros((rows, b), np.int32)
    op[0] = -1
    op[0, 0], op[1, 0], op[2] = 77, 2, now
    if rows == 5:
        op[4, 0] = 3
    return torch.from_numpy(op)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["acquire_packed", "acquire_grouped",
                                     "window_packed", "window_grouped"])
def test_flush_one_valid_row_matches_plain(cuda_device, wrapper):
    fn = getattr(ck, wrapper)
    rows = 5 if wrapper.endswith("grouped") else 4
    op = _one_valid_row(rows)
    if wrapper.startswith("acquire"):
        plain, card = _state(3, cuda_device)
        args = (CAP, 0.013)
    else:
        plain, card = _windows(4, cuda_device)
        args = (W_LIMIT, W_TICKS)
    for t in (plain, card):  # the row's slot starts empty
        t.exists[77] = False
    want = fn(plain, op, *args)
    got = fn(card, op.to(cuda_device), *args)
    torch.cuda.synchronize()
    _assert_exact(card, plain, got, want)
    assert float(want[1, 0]) > 0 and float(want[1, 1:].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("k,b", [(32, B), (31, 104)])
@pytest.mark.parametrize("fused,with_remaining,distinct", [
    (True, True, False), (True, False, False), (False, True, False),
    (True, False, True)])
def test_window_scan_matches_plain(cuda_device, fused, with_remaining, k, b,
                                   distinct, interpolate):
    """K window batches in one launch against the plain per-batch loop, the
    ticks crossing window boundaries within the chunk."""
    limit = W_LIMIT if fused else 5000.0
    plain, card = _windows(9, cuda_device)
    operand = _scan_operand(np.random.default_rng(10), k, b, N, fused,
                            distinct)
    nows = torch.tensor([50_000 + 700 * (3 * i // k) for i in range(k)],
                        dtype=torch.int32)
    before = dict(ck.launches)
    want = ck.window_scan_packed(plain, operand, nows, limit, W_TICKS,
                                 interpolate=interpolate,
                                 with_remaining=with_remaining)
    got = ck.window_scan_packed(card, operand.to(cuda_device),
                                nows.to(cuda_device), limit, W_TICKS,
                                interpolate=interpolate,
                                with_remaining=with_remaining)
    torch.cuda.synchronize()
    assert ck.launches["window_scan"] == before["window_scan"] + 1
    assert sum(ck.launches.values()) == sum(before.values()) + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _assert_windows_same(card, plain)
    grants = (want[:, 0] if with_remaining else torch.from_numpy(
        np.unpackbits(want.numpy(), axis=-1, bitorder="little")))
    assert 0 < int(grants.sum()) < grants.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["packed", "scan"])
def test_window_int32_wraparound_matches_plain(cuda_device, kernel):
    """Ticks near 2^31 - 1 and stored indices whose ``idx * W`` and index
    differences wrap as int32 (a clock behind them, restored state): the
    kernel wraps through uint32 exactly as the plain version's int64 wrap."""
    n, w = 64, 7919
    now = 2**31 - 5
    rng = np.random.default_rng(11)
    idx = np.concatenate([
        np.full(16, now // w, np.int64), np.full(16, now // w - 1),
        rng.integers(2**30, 2**31 - 1, 16), rng.integers(-2**31, -2**30, 16)])
    arrays = (rng.integers(0, 9, n).astype(np.float32),
              rng.integers(0, 9, n).astype(np.float32), idx.astype(np.int32),
              np.ones(n, bool))
    plain, card = [K.WindowState(*(torch.tensor(a, device=d) for a in arrays))
                   for d in ("cpu", cuda_device)]
    slots = np.arange(n, dtype=np.int32)
    counts = rng.integers(0, 4, n).astype(np.int32)
    if kernel == "packed":
        op = torch.from_numpy(np.stack([slots, counts, np.full(n, now,
                                                               np.int32),
                                        np.zeros(n, np.int32)]))
        want = ck.window_packed(plain, op, 10.0, w)
        got = ck.window_packed(card, op.to(cuda_device), 10.0, w)
    else:
        op = torch.from_numpy(np.stack([slots, counts])[:, None])
        nows = torch.tensor([now], dtype=torch.int32)
        want = ck.window_scan_packed(plain, op, nows, 10.0, w)
        got = ck.window_scan_packed(card, op.to(cuda_device),
                                    nows.to(cuda_device), 10.0, w)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _assert_windows_same(card, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("now", [50_000, -3_001, 2**31 - 1])
def test_sweep_windows_kernel_matches_plain(cuda_device, now):
    """Two windows behind expires; indices far on either side wrap."""
    n = 70_000
    rng = np.random.default_rng(12)
    base = now // W_TICKS
    idx = (base - rng.integers(-1, 5, n)).astype(np.int64)
    far = rng.random(n) < 0.05
    idx[far] = rng.integers(-2**31, 2**31 - 1, int(far.sum()))
    arrays = (np.zeros(n, np.float32), np.zeros(n, np.float32),
              np.clip(idx, -2**31, 2**31 - 1).astype(np.int32),
              rng.random(n) < 0.5)
    plain, card = [K.WindowState(*(torch.tensor(a, device=d) for a in arrays))
                   for d in ("cpu", cuda_device)]
    want = ck.sweep_windows(plain, now, W_TICKS)
    got = ck.sweep_windows(card, now, W_TICKS)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), wnt.numpy())
    _assert_windows_same(card, plain)
    assert 0 < int(want[1].sum()) < int(arrays[3].sum())


def _semas(seed, n, device, now=50_000):
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(0, 6, n).astype(np.int32),
              rng.integers(now - 3000, now + 50, n).astype(np.int32),
              rng.random(n) < 0.6)
    return [K.SemaState(*(torch.tensor(a, device=d) for a in arrays))
            for d in ("cpu", device)]


def _sema_operand(seed, b, n, now=50_000, shape="zipf"):
    """Zipf slots (repeats), padding and out-of-range rows; acquires up to
    3, releases, probes; limits 0 to 8. ``shape`` "distinct": no slot
    repeats, no padding; "hot": every row one slot (acquires and probes,
    limit 40)."""
    rng = np.random.default_rng(seed)
    if shape == "distinct":
        slots = rng.choice(n, b, replace=False).astype(np.int32)
    elif shape == "hot":
        slots = np.full(b, 11, np.int32)
    else:
        slots = np.minimum(rng.zipf(1.3, b) - 1, n - 1).astype(np.int32)
        slots[rng.random(b) < 0.05] = -1
        slots[rng.random(b) < 0.03] = n + 3
    deltas = rng.integers(-2, 4, b).astype(np.int32)
    limits = rng.integers(0, 9, b).astype(np.int32)
    if shape == "hot":
        deltas = rng.integers(0, 4, b).astype(np.int32)
        limits[:] = 40
    return torch.from_numpy(np.stack([slots, deltas, limits,
                                      np.full(b, now, np.int32)]))


def _assert_tables_equal(card, plain):
    for c, p in zip(card, plain):
        np.testing.assert_array_equal(c.cpu().numpy(), p.cpu().numpy())


#: The semaphore kernel's shapes: the warp path (B <= 32) and the block
#: path, with repeats (Zipf), with none, and one hot slot.
SEMA_SHAPES = [("zipf", 8), ("zipf", 1000), ("zipf", 2048), ("zipf", 4096),
               ("zipf", 1), ("zipf", 32), ("zipf", 33), ("distinct", 8),
               ("distinct", 33), ("distinct", 4096), ("hot", 32),
               ("hot", 1000), ("hot", 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,b", SEMA_SHAPES)
def test_sema_kernel_matches_plain(cuda_device, shape, b):
    plain, card = _semas(b, 4096, cuda_device)
    if shape == "hot":  # the hot slot starts empty
        for t in (plain, card):
            t.active[11] = 0
    op = _sema_operand(b + 1, b, 4096, shape=shape)
    before = dict(ck.launches)
    want = ck.sema_packed(plain, op)
    got = ck.sema_packed(card, op.to(cuda_device))
    torch.cuda.synchronize()
    assert ck.launches["sema_packed"] == before["sema_packed"] + 1
    assert sum(ck.launches.values()) == sum(before.values()) + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _assert_tables_equal(card, plain)
    if b > 1:  # one row cannot both grant and deny
        assert 0 < float(want[0].sum()) < b


@pytest.mark.cuda
def test_sweep_semas_kernel_matches_plain(cuda_device):
    n, now = 2**20 + 5, 3 * 86400 * 1024
    rng = np.random.default_rng(9)
    arrays = (rng.integers(0, 2, n).astype(np.int32),
              rng.integers(now - 2 * 86400 * 1024, now, n).astype(np.int32),
              rng.random(n) < 0.5)
    plain, card = [K.SemaState(*(torch.tensor(a, device=d) for a in arrays))
                   for d in ("cpu", cuda_device)]
    gmask, gcounts = ck.sweep_semas(card, now)
    wmask, wcounts = ck.sweep_semas(plain, now)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(gmask.cpu().numpy(), wmask.numpy())
    np.testing.assert_array_equal(gcounts.cpu().numpy(), wcounts.numpy())
    _assert_tables_equal(card, plain)
    held = arrays[0] > 0
    assert not (wmask.numpy().astype(bool) & held).any()  # held: never swept
    assert 0 < int(wcounts.sum()) < int(arrays[2].sum())


def _bucket_pair(seed, n, device, cap, now=50_000):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0, cap, n).astype(np.float32),
              rng.integers(now - 3000, now + 50, n).astype(np.int32),
              rng.random(n) < 0.6)
    return [K.BucketState(*(torch.tensor(a, device=d) for a in arrays))
            for d in ("cpu", device)]


#: The two-level kernel's shapes: the warp path (B <= 32) and the block
#: path; Zipf keys and tenants (a key's rows under several tenants: one
#: block decides a large batch), distinct keys and tenants, one hot key of
#: one tenant, distinct keys of one tenant, and Zipf keys scoped to their
#: Zipf tenant (a large batch spread over blocks by tenant, with repeats at
#: both levels).
HIER_SHAPES = [("zipf", 100), ("zipf", 4096), ("zipf", 1), ("zipf", 8),
               ("zipf", 32), ("zipf", 33), ("distinct", 8),
               ("distinct", 33), ("distinct", 4096), ("hot", 32),
               ("hot", 4096), ("one_tenant", 32), ("one_tenant", 1000),
               ("one_tenant", 4096), ("scoped", 1000), ("scoped", 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,b", HIER_SHAPES)
def test_hierarchical_kernel_matches_plain(cuda_device, shape, b):
    """Tokens equal bit for bit too: whole costs below 2^24, where the
    kernel's one subtraction of a slot's int64 consumption equals the
    plain version's row by row."""
    rng = np.random.default_rng(b)
    cplain, ccard = _bucket_pair(1, 4096, cuda_device, 40.0)
    pplain, pcard = _bucket_pair(2, 64, cuda_device, 300.0)
    if shape == "distinct":
        cs = rng.choice(4096, b, replace=False).astype(np.int32)
        ps = (np.arange(b) % 64).astype(np.int32)
    elif shape == "hot":
        cs, ps = np.full(b, 5, np.int32), np.full(b, 6, np.int32)
    elif shape == "one_tenant":
        cs = rng.choice(4096, b, replace=False).astype(np.int32)
        ps = np.full(b, 6, np.int32)
    elif shape == "scoped":
        ps = (rng.zipf(1.2, b) % 64).astype(np.int32)
        cs = (ps * 64 + rng.zipf(1.5, b) % 64).astype(np.int32)
    else:
        cs = np.minimum(rng.zipf(1.5, b) - 1, 4095).astype(np.int32)
        ps = (rng.zipf(1.2, b) % 64).astype(np.int32)
        cs[rng.random(b) < 0.03] = -1
        ps[rng.random(b) < 0.03] = 70  # out of the parent table: padding
    # Distinct keys, and warp batches but the hot key's (few rows a key),
    # take costs up to 47, beyond a 40-token child, so that some rows are
    # denied.
    big = shape == "distinct" or (b <= 32 and shape != "hot")
    costs = rng.integers(0, 48 if big else 12, b)
    op = torch.from_numpy(np.stack([cs, costs.astype(np.int32),
                                    np.full(b, 50_000, np.int32), ps]))
    args = (40.0, 0.01, 300.0, 0.05)
    before = dict(ck.launches)
    want = ck.acquire_hierarchical(cplain, pplain, op, *args)
    got = ck.acquire_hierarchical(ccard, pcard, op.to(cuda_device), *args)
    torch.cuda.synchronize()
    assert ck.launches["acquire_hierarchical"] == (
        before["acquire_hierarchical"] + 1)
    assert sum(ck.launches.values()) == sum(before.values()) + 1
    _assert_same(ccard, cplain, got, want)
    _assert_same_state(pcard, pplain)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _assert_tables_equal(ccard, cplain)
    _assert_tables_equal(pcard, pplain)
    if b > 1:  # one row cannot both grant and deny
        assert 0 < float(want[0].sum()) < b


@pytest.mark.cuda
@pytest.mark.parametrize("distinct", [True, False])
def test_debit_kernel_matches_plain(cuda_device, distinct):
    from distributedratelimiting.redis_tpu_torch.ops import bucket_math

    b = 2**20 if distinct else 4096
    n = 2 * b
    rng = np.random.default_rng(b)
    plain, card = _bucket_pair(3, n, cuda_device, CAP)
    if distinct:
        slots = rng.permutation(n)[:b].astype(np.int32)
        amounts = rng.uniform(0, 12, b).astype(np.float32)
    else:
        slots = np.minimum(rng.zipf(1.3, b) - 1, n - 1).astype(np.int32)
        amounts = rng.uniform(-4, 8, b).astype(np.float32)
    slots[rng.random(b) < 0.02] = -1
    t_slots = torch.from_numpy(slots)
    prefix = bucket_math.duplicate_prefix_float(
        t_slots, torch.from_numpy(amounts), t_slots >= 0)
    op = torch.from_numpy(np.stack([
        slots, amounts.view(np.int32), np.full(b, 50_000, np.int32),
        prefix.numpy().view(np.int32)]))
    before = ck.launches["debit_packed"]
    want = ck.debit_packed(plain, op, CAP, 0.013)
    got = ck.debit_packed(card, op.to(cuda_device), CAP, 0.013)
    torch.cuda.synchronize()
    assert ck.launches["debit_packed"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    if distinct:
        _assert_tables_equal(card, plain)
        return
    # A slot of r rows takes r atomic adds in no fixed order: each rounds by
    # at most half a spacing of the largest partial sum, which is at most
    # the slot's value plus the magnitudes of its amounts.
    _assert_tables_equal(card[1:], plain[1:])
    got, want = card.tokens.cpu().numpy(), plain.tokens.numpy()
    ok = slots >= 0
    reps = np.bincount(slots[ok], minlength=n)
    mag = np.abs(want) + np.bincount(slots[ok], weights=np.abs(amounts[ok]),
                                     minlength=n)
    tol = np.where(reps > 1, reps, 0) * np.spacing(mag.astype(np.float32))
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()


def _slot_major_case(shape, n, rng):
    """Operands that stress the slot-major scan: ``(operand, nows)``.

    - ``cross``: one set of B slots, permuted, in every batch, each batch at
      a tick of its own and one tick going back (every slot chains K times);
    - ``hot``: one slot takes every row of a 32 x 4096 chunk;
    - ``k1``: K = 1, B = 4096 with three valid rows (the coalescing lane);
    - ``grown``: N = 2^24 + 12,345, Zipf rows half near the top.
    """
    if shape == "cross":
        base = rng.permutation(n)[:B].astype(np.int32)
        slots = np.stack([rng.permutation(base) for _ in range(32)])
        slots[rng.random(slots.shape) < 0.02] = -1
        nows = 50_000 + 97 * np.arange(32)
        nows[16] = nows[15] - 300
    elif shape == "hot":
        slots = np.full((32, 4096), 7, np.int32)
        nows = 50_000 + 300 * (3 * np.arange(32) // 32)
    elif shape == "k1":
        slots = np.full((1, 4096), -1, np.int32)
        slots[0, [5, 900, 4095]] = rng.choice(n, 3, replace=False)
        nows = np.array([50_000])
    else:
        slots = np.minimum(rng.zipf(1.3, (4, 4096)) - 1, n - 1)
        top = rng.random(slots.shape) < 0.5
        slots[top] = n - 1 - (rng.zipf(1.3, int(top.sum())) - 1) % 20_000
        slots = slots.astype(np.int32)
        slots[rng.random(slots.shape) < 0.02] = -1
        nows = 50_000 + 300 * (3 * np.arange(4) // 4)
    counts = rng.integers(0, 4, slots.shape).astype(np.uint8)
    return (torch.from_numpy(K.pack_compact5(slots, counts)),
            torch.tensor(nows, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("with_remaining", [False, True])
@pytest.mark.parametrize("shape", ["cross", "hot", "k1", "grown"])
@pytest.mark.parametrize("kernel", ["bucket", "sliding", "fixed"])
def test_scan_slot_major_shapes_match_plain(cuda_device, kernel, shape,
                                            with_remaining):
    """Both scans (buckets, sliding and fixed windows) at the shapes that
    stress the slot-major decomposition, against the plain per-batch loop
    on the same card tensors: one launch a call; grants, bits and every
    state field equal (tokens and remaining within ATOL)."""
    rng = np.random.default_rng(20)
    n = 2**24 + 12_345 if shape == "grown" else N
    operand, nows = _slot_major_case(shape, n, rng)
    operand, nows = operand.to(cuda_device), nows.to(cuda_device)
    if kernel == "bucket":
        arrays = (rng.uniform(0, CAP, n).astype(np.float32),
                  rng.integers(47_000, 50_050, n).astype(np.int32),
                  rng.random(n) < 0.6)
        card = K.BucketState(*(torch.tensor(a, device=cuda_device)
                               for a in arrays))
        plain = K.BucketState(*(t.clone() for t in card))
        name = "acquire_scan"
        before = dict(ck.launches)
        got = ck.acquire_scan_packed(card, operand, nows, CAP, 0.013,
                                     with_remaining=with_remaining)
        fn = (K.acquire_scan_fused_packed if with_remaining
              else K.acquire_scan_fused_bits)
        _, want = fn(plain, operand, nows, CAP, 0.013)
    else:
        interpolate = kernel == "sliding"
        idx = 50_000 // W_TICKS + rng.choice([-2, -1, 0, 0, 1], n)
        arrays = (rng.integers(0, 9, n).astype(np.float32),
                  rng.integers(0, 9, n).astype(np.float32),
                  idx.astype(np.int32), rng.random(n) < 0.6)
        card = K.WindowState(*(torch.tensor(a, device=cuda_device)
                               for a in arrays))
        plain = K.WindowState(*(t.clone() for t in card))
        name = "window_scan"
        before = dict(ck.launches)
        got = ck.window_scan_packed(card, operand, nows, W_LIMIT, W_TICKS,
                                    interpolate=interpolate,
                                    with_remaining=with_remaining)
        fn = (K.window_acquire_scan_fused_packed if with_remaining
              else K.window_acquire_scan_fused_bits)
        _, want = fn(plain, operand, nows, W_LIMIT, W_TICKS,
                     interpolate=interpolate)
    torch.cuda.synchronize()
    assert ck.launches[name] == before[name] + 1
    assert sum(ck.launches.values()) == sum(before.values()) + 1
    if with_remaining and kernel == "bucket":
        np.testing.assert_array_equal(got[:, 0].cpu().numpy(),
                                      want[:, 0].cpu().numpy())
        np.testing.assert_allclose(got[:, 1].cpu().numpy(),
                                   want[:, 1].cpu().numpy(), atol=ATOL,
                                   rtol=0)
    else:
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if kernel == "bucket":
        _assert_same_state(card, plain)
    else:
        _assert_windows_same(card, plain)
    grants = (want[:, 0] > 0.5 if with_remaining else torch.from_numpy(
        np.unpackbits(want.cpu().numpy(), axis=-1, bitorder="little")))
    assert 0 < int(grants.sum()) < grants.numel()


# -- The bench's kernels: the 3-byte scan, the fused scan at B = 8192, and
# acquire_batch (the scan at K = 1 over separate arrays) -----------------------

def _bench_slots(rng, shape, n, pad, distinct=False):
    """Zipf(1.3) slots (repeats within and across batches, hot slots past
    the capacity), or slots distinct within each batch; ~2% padding
    ``pad`` and ~1% ids >= n."""
    if distinct:
        slots = np.stack([rng.permutation(n)[:shape[-1]]
                          for _ in range(int(np.prod(shape[:-1])))]
                         ).reshape(shape).astype(np.int64)
    else:
        slots = np.minimum(rng.zipf(1.3, shape) - 1, n - 1).astype(np.int64)
    slots[rng.random(shape) < 0.02] = pad
    slots[rng.random(shape) < 0.01] = n + 3
    return slots


def _exact_state(card, plain):
    for name in plain._fields:
        np.testing.assert_array_equal(getattr(card, name).cpu().numpy(),
                                      getattr(plain, name).cpu().numpy(),
                                      err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("k,b,distinct", [(3, 100, False), (32, 8192, False),
                                          (32, 8192, True), (17, 8192, False),
                                          (40, 4096, False)])
@pytest.mark.parametrize("width", [3, 5])
def test_bench_scans_match_plain(cuda_device, k, b, distinct, width):
    """Both bench scans against their plain versions on a CPU copy: grants,
    remaining and every state field bit for bit (whole counts, one writer a
    slot, demand far below 2^24); one launch per piece of at most 2^17
    rows, in order."""
    rng = np.random.default_rng(k * b + width)
    n = 2**20 if distinct else N
    plain, card = _state(11, cuda_device, n=n)
    nows = _nows(k)
    if width == 3:
        op = torch.from_numpy(K.pack_slots24(
            _bench_slots(rng, (k, b), n, K.SLOT24_PAD, distinct)))
        wrapper, name = ck.acquire_scan_packed24, "acquire_scan24"
    else:
        op = torch.from_numpy(K.pack_compact5(
            _bench_slots(rng, (k, b), n, -1, distinct).astype(np.int32),
            rng.integers(0, 4, (k, b)).astype(np.uint8)))
        wrapper, name = ck.acquire_scan_compact_fused, "acquire_scan"
    before = dict(ck.launches)
    want = wrapper(plain, op, nows, CAP, 0.013)
    got = wrapper(card, op.to(cuda_device), nows.to(cuda_device), CAP, 0.013)
    torch.cuda.synchronize()
    launched = len(ck._pieces(k, b))
    assert launched == -(-k * b // ck.SCAN_MAX_ROWS)
    assert ck.launches[name] == before[name] + launched
    assert sum(ck.launches.values()) == sum(before.values()) + launched
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _exact_state(card, plain)
    assert 0 < int(want[:, 0].sum()) < want[:, 0].numel()


@pytest.mark.cuda
def test_packed24_padding_and_far_ids_touch_nothing(cuda_device):
    """SLOT24_PAD and ids >= N are denied, answer remaining 0 and leave the
    table as it was."""
    plain, card = _state(12, cuda_device)
    slots = np.array([[K.SLOT24_PAD, N, N + 1, K.SLOT24_PAD - 1] * 16],
                     np.int64)
    op = torch.from_numpy(K.pack_slots24(slots)).to(cuda_device)
    got = ck.acquire_scan_packed24(card, op, _nows(1).to(cuda_device), CAP,
                                   0.013)
    torch.cuda.synchronize()
    assert not got.any()
    _exact_state(card, plain)


def _assert_slots_within_adds(card, plain, slots, valid, n):
    """Tokens after a batch without the duplicate serialization: a slot's
    rows all decide from its refilled balance, and the kernel subtracts
    their int64 consumption once where the plain version subtracts row by
    row, so a balance driven far below zero may round differently: each
    slot within r float32 spacings for r rows (a slot with one row equal)."""
    got = card.tokens.cpu().numpy().astype(np.float64)
    want = plain.tokens.numpy().astype(np.float64)
    s = slots[valid & (slots >= 0) & (slots < n)]
    reps = np.bincount(s, minlength=n)
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
    tol = np.where(reps > 1, reps, 0) * np.spacing(mag).astype(np.float64)
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 33, 64, 4096, 8192])
@pytest.mark.parametrize("handle_duplicates", [True, False])
@pytest.mark.parametrize("zipf", [True, False])
def test_acquire_batch_matches_plain(cuda_device, b, handle_duplicates, zipf):
    """acquire_batch against its plain version on a CPU copy: grants and
    remaining equal, last_ts and exists equal; tokens bit for bit with the
    duplicate serialization (the granted consumption never passes the
    balance), and within r spacings without it. One launch."""
    rng = np.random.default_rng(b + 2 * handle_duplicates + zipf)
    n = 2**14
    plain, card = _state(13, cuda_device, n=n)
    slots = _bench_slots(rng, (b,), n, -1, distinct=not zipf).astype(np.int32)
    counts = rng.integers(0, 4, b).astype(np.int32)
    valid = rng.random(b) < 0.95
    args = [torch.from_numpy(a) for a in (slots, counts, valid)]
    before = dict(ck.launches)
    want = ck.acquire_batch(plain, *args, 50_100, CAP, 0.013,
                            handle_duplicates=handle_duplicates)
    got = ck.acquire_batch(card, *(a.to(cuda_device) for a in args), 50_100,
                           CAP, 0.013, handle_duplicates=handle_duplicates)
    torch.cuda.synchronize()
    assert ck.launches["acquire_batch"] == before["acquire_batch"] + 1
    assert sum(ck.launches.values()) == sum(before.values()) + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    for name in ("last_ts", "exists"):
        np.testing.assert_array_equal(getattr(card, name).cpu().numpy(),
                                      getattr(plain, name).numpy())
    if handle_duplicates:
        np.testing.assert_array_equal(card.tokens.cpu().numpy(),
                                      plain.tokens.numpy())
    else:
        _assert_slots_within_adds(card, plain, slots, valid, n)
    if zipf and b >= 64 and not handle_duplicates:
        assert (plain.tokens < 0).any()  # JAX's semantics: below zero


@pytest.mark.cuda
def test_scan_formats_refuse_past_their_widths(cuda_device):
    _, card = _state(14, cuda_device)
    with pytest.raises(ValueError, match="at most 8192"):
        ck.acquire_scan_packed24(
            card, torch.zeros((1, 8193, 3), dtype=torch.uint8,
                              device=cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device), CAP, 0.1)
    with pytest.raises(ValueError, match="at most 8192"):
        ck.acquire_batch(card, *(torch.zeros(8193, dtype=d, device=cuda_device)
                                 for d in (torch.int32, torch.int32,
                                           torch.bool)), 0, CAP, 0.1)


@pytest.mark.cuda
def test_late_device_trace_records_kernels(cuda_device, tmp_path):
    """ROADMAP Queue C1: a ``torch.profiler`` session with CUDA activity
    runs first (as a timing harness's would), then
    ``tracing.start_device_trace`` / ``stop_device_trace`` around a bulk on
    a card store in the same process: the late trace holds the bulk's
    kernels, each inside a ``drl/`` range's time."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from distributedratelimiting.redis_tpu_torch.runtime.store import (
        DeviceBucketStore,
    )
    from distributedratelimiting.redis_tpu_torch.utils import tracing

    x = torch.ones(1 << 20, device=cuda_device)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                (x * 2).sum()
            torch.cuda.synchronize()
        assert sum(e.device_time_total for e in prof.key_averages()) > 0

    async def body() -> str:
        store = DeviceBucketStore(device="cuda", n_slots=1 << 16,
                                  max_batch=4096)
        try:
            keys = [f"c1-{i}" for i in range(40_000)]
            await store.acquire_many(keys, [1] * len(keys), 100.0, 10.0)
            tracing.start_device_trace(str(tmp_path))
            try:
                res = await store.acquire_many(keys, [1] * len(keys), 100.0,
                                               10.0)
                torch.cuda.synchronize()
            finally:
                path = tracing.stop_device_trace()
            assert np.asarray(res.granted).all()
            return path
        finally:
            await store.aclose()

    with open(asyncio.run(body())) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ranges = [e for e in events if str(e.get("name", "")).startswith("drl/")]
    assert ranges, "the late trace holds no drl/ range"
    assert kernels, "the late trace holds no kernel (ROADMAP C1)"
    assert any("scan" in k["name"] for k in kernels)
