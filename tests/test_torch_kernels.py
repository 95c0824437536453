"""The port's batch operations against the JAX package's, on seeded inputs.

Each case feeds the same numpy state and operand to the JAX function and to
the port's plain PyTorch version (which is what the kernel wrappers run on
a CPU tensor). Tolerances: grants and group grant counts identical;
``last_ts`` and ``exists`` exact; remaining and tokens within atol 1e-4 —
duplicates' consumption is scatter-added, and on the card atomics add it in
no fixed order (counts stay far below 2^24, so integer parts are exact).
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from distributedratelimiting.redis_tpu.ops import bucket_math as bm
from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu.ops.pallas_kernels import (
    sweep_expired_pallas,
)
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import kernels as TK

# Small tensors: one intra-op thread, so that parallel test workers keep
# their cores.
torch.set_num_threads(1)

ATOL = 1e-4
CAP = 10.0
N = 512
INTERPRET = jax.devices()[0].platform != "tpu"


def _state_np(n, seed, now=50_000):
    rng = np.random.default_rng(seed)
    tokens = rng.uniform(0, CAP, n).astype(np.float32)
    last_ts = rng.integers(now - 3000, now + 50, n).astype(np.int32)
    exists = rng.random(n) < 0.6
    return tokens, last_ts, exists


def _jax_state(s):
    return JK.BucketState(*(jnp.asarray(a) for a in s))


def _torch_state(s, device="cpu"):
    return TK.BucketState(*(torch.tensor(a, device=device) for a in s))


def _assert_state(tstate, jstate):
    np.testing.assert_allclose(tstate.tokens.cpu().numpy(),
                               np.asarray(jstate.tokens), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tstate.last_ts.cpu().numpy(),
                                  np.asarray(jstate.last_ts))
    np.testing.assert_array_equal(tstate.exists.cpu().numpy(),
                                  np.asarray(jstate.exists))


def _slots_np(rng, b, n):
    """Zipf-like duplicates, padding (-1) and out-of-range slots."""
    slots = np.minimum(rng.zipf(1.3, b) - 1, n - 1).astype(np.int32)
    slots[rng.random(b) < 0.1] = -1
    slots[rng.random(b) < 0.05] = n + 3
    return slots


def _packed4(seed, b=256, n=N, now=50_000):
    rng = np.random.default_rng(seed)
    slots = _slots_np(rng, b, n)
    counts = rng.integers(0, 4, b).astype(np.int32)  # zero-count probes too
    valid = (slots >= 0) & (slots < n)
    prefix = np.asarray(bm.duplicate_prefix(
        jnp.asarray(slots), jnp.asarray(counts), jnp.asarray(valid)))
    return np.stack([slots, counts, np.full(b, now, np.int32),
                     prefix.astype(np.int32)])


def _packed5(seed, b=256, n=N, now=50_000):
    rng = np.random.default_rng(seed)
    slots = _slots_np(rng, b, n)
    counts = rng.integers(0, 4, b).astype(np.int32)
    sizes = rng.integers(1, 6, b).astype(np.int32)
    valid = (slots >= 0) & (slots < n)
    demand = counts * sizes
    prefix = np.asarray(bm.duplicate_prefix(
        jnp.asarray(slots), jnp.asarray(demand), jnp.asarray(valid)))
    return np.stack([slots, counts, np.full(b, now, np.int32),
                     prefix.astype(np.int32), sizes])


@pytest.mark.parametrize("rate", [10 / 1024, 0.013])
@pytest.mark.parametrize("seed", range(3))
def test_acquire_batch_packed_matches(seed, rate):
    s = _state_np(N, seed)
    packed = _packed4(seed + 100)
    jstate, jout = JK.acquire_batch_packed(_jax_state(s), jnp.asarray(packed),
                                           jnp.float32(CAP), jnp.float32(rate))
    tstate = _torch_state(s)
    tout = ck.acquire_packed(tstate, torch.from_numpy(packed), CAP, rate)
    jout = np.asarray(jout)
    np.testing.assert_array_equal(tout[0].numpy(), jout[0])
    np.testing.assert_allclose(tout[1].numpy(), jout[1], atol=ATOL, rtol=0)
    _assert_state(tstate, jstate)
    assert jout[0].sum() > 0 and (jout[0] == 0).any()  # both outcomes seen


@pytest.mark.parametrize("rate", [10 / 1024, 0.013])
@pytest.mark.parametrize("seed", range(3))
def test_acquire_batch_packed_grouped_matches(seed, rate):
    s = _state_np(N, seed)
    packed = _packed5(seed + 200)
    jstate, jout = JK.acquire_batch_packed_grouped(
        _jax_state(s), jnp.asarray(packed), jnp.float32(CAP),
        jnp.float32(rate))
    tstate = _torch_state(s)
    tout = ck.acquire_grouped(tstate, torch.from_numpy(packed), CAP, rate)
    jout = np.asarray(jout)
    np.testing.assert_array_equal(tout[0].numpy(), jout[0])
    np.testing.assert_allclose(tout[1].numpy(), jout[1], atol=ATOL, rtol=0)
    _assert_state(tstate, jstate)


def _fused(seed, k=3, b=64, n=N):
    rng = np.random.default_rng(seed)
    slots = np.stack([_slots_np(rng, b, n) for _ in range(k)])
    counts = rng.integers(0, 4, (k, b)).astype(np.uint8)
    nows = np.array([50_000 + 700 * i for i in range(k)], np.int32)
    return JK.pack_compact5(slots, counts), nows


@pytest.mark.parametrize("seed", range(3))
def test_acquire_scan_fused_packed_matches(seed):
    s = _state_np(N, seed)
    fused, nows = _fused(seed + 300)
    np.testing.assert_array_equal(
        TK.pack_compact5(*_unpack_np(fused)), fused)
    rate = 10 / 1024
    jstate, jout = JK.acquire_scan_fused_packed(
        _jax_state(s), jnp.asarray(fused), jnp.asarray(nows),
        jnp.float32(CAP), jnp.float32(rate))
    tstate, tout = TK.acquire_scan_fused_packed(
        _torch_state(s), torch.from_numpy(fused), torch.from_numpy(nows),
        CAP, rate)
    jout = np.asarray(jout)
    assert tout.shape == jout.shape
    np.testing.assert_array_equal(tout[:, 0].numpy(), jout[:, 0])
    np.testing.assert_allclose(tout[:, 1].numpy(), jout[:, 1], atol=ATOL,
                               rtol=0)
    _assert_state(tstate, jstate)


@pytest.mark.parametrize("seed", range(3))
def test_acquire_scan_fused_bits_matches(seed):
    s = _state_np(N, seed)
    fused, nows = _fused(seed + 400)
    rate = 0.013
    jstate, jbits = JK.acquire_scan_fused_bits(
        _jax_state(s), jnp.asarray(fused), jnp.asarray(nows),
        jnp.float32(CAP), jnp.float32(rate))
    tstate, tbits = TK.acquire_scan_fused_bits(
        _torch_state(s), torch.from_numpy(fused), torch.from_numpy(nows),
        CAP, rate)
    assert tbits.dtype == torch.uint8
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    _assert_state(tstate, jstate)


def _unpack_np(fused):
    slots = fused[..., :4].copy().view("<i4")[..., 0]
    return slots, fused[..., 4]


def test_unpack_compact5_keeps_negative_padding():
    slots = np.array([[-1, 0, 2**24 + 5, 2**31 - 1]], np.int32)
    got, counts = TK._unpack_compact5(
        torch.from_numpy(TK.pack_compact5(slots, [[0, 1, 2, 255]])))
    np.testing.assert_array_equal(got.numpy(), slots)
    np.testing.assert_array_equal(counts.numpy(), [[0, 1, 2, 255]])


@pytest.mark.parametrize("with_remaining", [True, False])
def test_scan_wrapper_matches_fused_plain(with_remaining):
    """The i32 operand (slots, then counts) decides as the fused one."""
    s = _state_np(N, 5)
    fused, nows = _fused(55)
    slots_k, counts_k = TK._unpack_compact5(torch.from_numpy(fused))
    a = ck.acquire_scan_packed(_torch_state(s), torch.stack([slots_k,
                                                             counts_k]),
                               torch.from_numpy(nows), CAP, 0.013,
                               with_remaining=with_remaining)
    _, b = TK.acquire_scan_fused_packed(_torch_state(s),
                                        torch.from_numpy(fused),
                                        torch.from_numpy(nows), CAP, 0.013)
    if not with_remaining:
        b = TK.pack_grant_bits(b[:, 0] > 0.5)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _scan_case(seed, fused, k=6, b=64, n=N):
    """K batches sharing hot slots within and across batches, padding and
    out-of-range rows, three ticks; the fused operand (u8 counts) or the
    i32 one with counts up to 1000."""
    rng = np.random.default_rng(seed)
    slots = np.stack([_slots_np(rng, b, n) for _ in range(k)])
    nows = np.array([50_000] * 2 + [50_400] * 2 + [51_500] * (k - 4),
                    np.int32)
    if fused:
        counts = rng.integers(0, 4, (k, b)).astype(np.uint8)
        return JK.pack_compact5(slots, counts), slots, counts, nows
    counts = rng.integers(0, 1001, (k, b)).astype(np.int32)
    return np.stack([slots, counts]), slots, counts, nows


@pytest.mark.parametrize("with_remaining", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed", range(2))
def test_scan_wrapper_matches_jax(seed, fused, with_remaining):
    """The bulk-lane wrapper on CPU tensors against the JAX scans: the
    fused operand through ``acquire_scan_fused_packed``/``_bits``, the i32
    one through ``acquire_scan_compact_packed``/``_bits``."""
    # Balances stay below 1024, where one float32 ulp is under ATOL: the
    # two scatter-adds add duplicates' consumption in different orders.
    cap = CAP if fused else 1000.0
    s = _state_np(N, seed)
    s = (s[0] * (cap / CAP), s[1], s[2])
    operand, slots, counts, nows = _scan_case(seed + 500, fused)
    assert len(set(nows)) == 3
    rate = 0.013
    jstate = _jax_state(s)
    if fused:
        fn = (JK.acquire_scan_fused_packed if with_remaining
              else JK.acquire_scan_fused_bits)
        jstate, jout = fn(jstate, jnp.asarray(operand), jnp.asarray(nows),
                          jnp.float32(cap), jnp.float32(rate))
    else:
        fn = (JK.acquire_scan_compact_packed if with_remaining
              else JK.acquire_scan_compact_bits)
        res = fn(jstate, jnp.asarray(slots), jnp.asarray(counts),
                 jnp.asarray(nows), jnp.float32(cap), jnp.float32(rate))
        jstate, jout = res[0], res[1]
    tstate = _torch_state(s)
    tout = ck.acquire_scan_packed(tstate, torch.from_numpy(operand),
                                  torch.from_numpy(nows), cap, rate,
                                  with_remaining=with_remaining)
    jout = np.asarray(jout)
    assert tout.shape == jout.shape
    if with_remaining:
        grants = jout[:, 0]
        np.testing.assert_array_equal(tout[:, 0].numpy(), grants)
        np.testing.assert_allclose(tout[:, 1].numpy(), jout[:, 1],
                                   atol=ATOL, rtol=0)
    else:
        assert tout.dtype == torch.uint8
        np.testing.assert_array_equal(tout.numpy(), jout)
        grants = np.unpackbits(jout, axis=-1, bitorder="little")
    _assert_state(tstate, jstate)
    assert grants.sum() > 0 and (grants == 0).any()  # both outcomes seen


def test_scan_bits_need_whole_bytes():
    s = _state_np(N, 1)
    operand = np.zeros((2, 1, 12), np.int32)
    with pytest.raises(ValueError, match="B % 8"):
        ck.acquire_scan_packed(_torch_state(s), torch.from_numpy(operand),
                               torch.zeros(1, dtype=torch.int32), CAP, 0.01,
                               with_remaining=False)


def test_padding_rows_never_touch_state():
    s = _state_np(N, 9)
    packed = np.stack([np.array([-1, -7, N, N + 100], np.int32),
                       np.full(4, 3, np.int32), np.full(4, 60_000, np.int32),
                       np.zeros(4, np.int32)])
    tstate = _torch_state(s)
    out = ck.acquire_packed(tstate, torch.from_numpy(packed), CAP, 1.0)
    assert not out.any()
    np.testing.assert_array_equal(tstate.tokens.numpy(), s[0])
    np.testing.assert_array_equal(tstate.last_ts.numpy(), s[1])
    np.testing.assert_array_equal(tstate.exists.numpy(), s[2])


def test_peek_batch_packed_matches():
    s = _state_np(N, 4)
    packed = _packed4(44)
    ref = JK.peek_batch_packed(_jax_state(s), jnp.asarray(packed),
                               jnp.float32(CAP), jnp.float32(0.013))
    tstate = _torch_state(s)
    got = TK.peek_batch_packed(tstate, torch.from_numpy(packed), CAP, 0.013)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tstate.exists.numpy(), s[2])  # read-only


def _sweep_state(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 100, n).astype(np.float32),
            rng.integers(0, 1000, n).astype(np.int32),
            rng.random(n) < 0.5)


@pytest.mark.parametrize("n,rate", [(4096, 0.001), (70_000, 0.001),
                                    (65_536, 0.05), (70_000, 0.0),
                                    (4096, 1e-9)])
def test_sweep_matches_pallas_and_xla(n, rate):
    s = _sweep_state(n, n)
    now, cap = 2_000_000, 100.0
    p_exists, p_mask, p_counts = sweep_expired_pallas(
        jnp.asarray(s[0]), jnp.asarray(s[1]),
        jnp.asarray(s[2].astype(np.int8)), now, cap, rate,
        interpret=INTERPRET)
    _, x_freed = JK.sweep_expired(_jax_state(s), jnp.int32(now),
                                  jnp.float32(cap), jnp.float32(rate))
    tstate = _torch_state(s)
    mask, counts = ck.sweep_expired(tstate, now, cap, rate)
    assert mask.dtype == torch.int8 and counts.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(p_mask))
    np.testing.assert_array_equal(mask.numpy().astype(bool),
                                  np.asarray(x_freed))
    np.testing.assert_array_equal(tstate.exists.numpy(),
                                  np.asarray(p_exists).astype(bool))
    # Tile counts exact at the TPU kernel's 32768-slot tiles.
    np.testing.assert_array_equal(counts.numpy(), np.asarray(p_counts))
    assert int(counts.sum()) == int(np.asarray(x_freed).sum())


def test_sweep_ttl_saturation_keeps_live_slots():
    """With a zero or tiny fill rate the TTL saturates at 2^31 - 1 ticks:
    nothing has been idle that long, so nothing expires (a wrapped TTL
    would expire every live slot)."""
    n = 4096
    s = _sweep_state(n, 1)
    s = (s[0] * 0.9, s[1], s[2])  # deficits >= 10 tokens: TTL saturates
    for rate in (0.0, 1e-9):
        tstate = _torch_state(s)
        mask, counts = ck.sweep_expired(tstate, 2_000_000, 100.0, rate)
        assert int(counts.sum()) == 0 and not mask.any()
        np.testing.assert_array_equal(tstate.exists.numpy(), s[2])


def test_wrapper_rejects_other_devices():
    st = TK.init_bucket_state(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ck.sweep_expired(st, 0, 1.0, 1.0)


def test_launch_counts_untouched_on_cpu():
    ck.reset_launches()
    s = _state_np(N, 2)
    ck.acquire_packed(_torch_state(s), torch.from_numpy(_packed4(2)), CAP,
                      0.01)
    ck.acquire_grouped(_torch_state(s), torch.from_numpy(_packed5(2)), CAP,
                       0.01)
    fused, nows = _fused(2)
    ck.acquire_scan_packed(_torch_state(s), torch.from_numpy(fused),
                           torch.from_numpy(nows), CAP, 0.01)
    ck.sweep_expired(_torch_state(s), 60_000, CAP, 0.01)
    counters = TK.init_counter_state(N)
    ck.sync_counters(counters, torch.from_numpy(_sync_operand(2)), 0.01)
    ck.sweep_counters(counters, 60_000)
    windows = TK.init_window_state(N)
    ck.window_packed(windows, torch.from_numpy(_packed4(2)), CAP, 1000)
    ck.window_grouped(windows, torch.from_numpy(_packed5(2)), CAP, 1000,
                      interpolate=False)
    ck.window_scan_packed(windows, torch.from_numpy(fused),
                          torch.from_numpy(nows), CAP, 1000)
    ck.sweep_windows(windows, 60_000, 1000)
    semas = TK.init_sema_state(N)
    sema_op = _packed4(2).copy()
    sema_op[3] = 60_000
    ck.sema_packed(semas, torch.from_numpy(sema_op))
    ck.sweep_semas(semas, 60_000)
    ck.acquire_hierarchical(_torch_state(s), TK.init_bucket_state(N),
                            torch.from_numpy(_packed4(2)), CAP, 0.01,
                            2 * CAP, 0.01)
    ck.debit_packed(_torch_state(s), torch.from_numpy(_packed4(2)), CAP,
                    0.01)
    ck.acquire_scan_compact_fused(_torch_state(s), torch.from_numpy(fused),
                                  torch.from_numpy(nows), CAP, 0.01)
    ck.acquire_scan_packed24(
        _torch_state(s),
        torch.from_numpy(TK.pack_slots24(np.arange(8 * nows.size).reshape(
            nows.size, 8))), torch.from_numpy(nows), CAP, 0.01)
    slots = torch.from_numpy(_packed4(2)[0])
    ck.acquire_batch(_torch_state(s), slots, torch.ones_like(slots),
                     slots >= 0, 60_000, CAP, 0.01, handle_duplicates=False)
    # The fingerprint directory's wrappers, on CPU tables too.
    from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F

    kp = torch.arange(1, 17, dtype=torch.int32).view(8, 2)
    valid = torch.ones(8, dtype=torch.bool)
    fused = torch.cat([kp, torch.ones(8, 1, dtype=torch.int32)], 1)
    fp, st = F.init_fp_table(N), _torch_state(s)
    ck.fp_acquire_scan(fp, st, fused.view(1, 8, 3),
                       torch.tensor([60_000], dtype=torch.int32), CAP, 0.01)
    ck.fp_window_scan(F.init_fp_table(N), TK.init_window_state(N),
                      fused.view(1, 8, 3),
                      torch.tensor([60_000], dtype=torch.int32), CAP, 1000)
    debit = torch.zeros((4, 8), dtype=torch.int32)
    debit[2] = 60_000
    ck.fp_debit(fp, st, kp, debit, CAP, 0.01)
    ck.fp_peek(fp, st, kp, valid, 60_000, CAP, 0.01)
    ck.fp_sweep_expired(fp, st, 60_000, CAP, 0.01)
    ck.fp_sweep_windows(F.init_fp_table(N), TK.init_window_state(N), 60_000,
                        1000)
    ck.fp_migrate(F.init_fp_table(N), TK.init_bucket_state(N), kp,
                  [t[:8] for t in st], valid)
    # The mesh's global tier, on a CPU counter.
    ck.global_tier(torch.ones((1, 2, 8)), torch.ones((1, 8), dtype=torch.int32),
                   torch.tensor([60_000], dtype=torch.int32),
                   TK.init_global_counter(), 0.01)
    assert set(ck.launches) == {"sweep_expired", "acquire_packed",
                                "acquire_grouped", "acquire_scan",
                                "acquire_scan24", "acquire_batch",
                                "sync_counters", "sweep_counters",
                                "window_packed", "window_grouped",
                                "window_scan", "sweep_windows",
                                "sema_packed", "sweep_semas",
                                "acquire_hierarchical", "debit_packed",
                                "fp_decide", "fp_window_decide", "fp_debit",
                                "fp_peek", "fp_sweep", "fp_sweep_windows",
                                "fp_migrate", "fp_migrate_window",
                                "global_tier"}
    assert all(v == 0 for v in ck.launches.values())


# -- decaying counters ------------------------------------------------------

def _counter_state_np(n, seed, now=50_000):
    """Half the counters live; some touched after ``now`` (a clock behind the
    stored timestamps), some long ago (deltas past 2^24 ticks)."""
    rng = np.random.default_rng(seed)
    value = rng.uniform(0, 1000, n).astype(np.float32)
    period = rng.uniform(0, 5000, n).astype(np.float32)
    last_ts = rng.integers(now - 3000, now + 200, n).astype(np.int32)
    last_ts[rng.random(n) < 0.1] = now - 2**25
    exists = rng.random(n) < 0.5
    return value, period, last_ts, exists


def _sync_operand(seed, b=256, n=N, now=50_000, distinct=False):
    """``i32[3, B]``: Zipf slots (or distinct ones), 5% padding, 3%
    out-of-range slots, float counts bitcast, the tick."""
    rng = np.random.default_rng(seed)
    if distinct:
        slots = rng.choice(n, b, replace=False).astype(np.int32)
    else:
        slots = np.minimum(rng.zipf(1.3, b) - 1, n - 1).astype(np.int32)
    slots[rng.random(b) < 0.05] = -1
    slots[rng.random(b) < 0.03] = n + 3
    counts = rng.uniform(0, 50, b).astype(np.float32)
    counts[slots == -1] = 0.0
    packed = np.stack([slots, counts.view(np.int32), np.full(b, now,
                                                             np.int32)])
    return packed


def _counter_jax(s):
    return JK.CounterState(*(jnp.asarray(a) for a in s))


def _counter_torch(s):
    return TK.CounterState(*(torch.tensor(a) for a in s))


def _assert_near_jax(got, want, mag):
    """Within two float32 ulps of the largest operand (``mag``): XLA on the
    CPU may contract ``v - delta * rate`` or the EWMA's ``0.8 * p + 0.2 *
    delta`` into one fused multiply-add (it did in ``sync_batch_packed``),
    where the port rounds each operation on its own; the two differ by at
    most half an ulp of the product plus one of the result."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), mag)
    assert np.all(np.abs(got - want) <= 2 * np.spacing(scale)), \
        np.abs(got - want).max()


def _sync_oracle(s, packed, rate):
    """Host float32 oracle of one sync, each operation rounded on its own
    in the plain version's order. Returns the replies ``f32[2, B]``, the new
    ``value`` and ``period``, and per row and per slot the magnitude of the
    largest operand (for :func:`_assert_near_jax`)."""
    value, period, last_ts, exists = (a.copy() for a in s)
    slots, now = packed[0], int(packed[2, 0])
    counts = packed[1].view(np.float32)
    rate = np.float32(rate)
    # Per slot, as if every slot were synced: decayed value and new EWMA.
    delta = np.maximum(0, now - np.where(exists, last_ts, 0)).astype(
        np.float32)
    decayed = np.where(exists, np.maximum(np.float32(0),
                                          value - delta * rate),
                       np.float32(0)).astype(np.float32)
    new_p = np.where(exists, np.float32(0.8) * period
                     + np.float32(0.2) * delta, delta).astype(np.float32)
    mag_v = np.maximum(np.abs(value), delta * rate)
    mag_p = np.maximum(np.float32(0.8) * np.abs(period),
                       np.float32(0.2) * delta)
    valid = (slots >= 0) & (slots < len(value))
    g = np.where(valid, slots, 0)
    replies = np.stack([decayed[g] + counts, new_p[g]])
    mags = np.stack([mag_v[g], mag_p[g]])
    value[slots[valid]] = decayed[slots[valid]]
    period[slots[valid]] = new_p[slots[valid]]
    np.add.at(value, slots[valid], counts[valid])
    return replies, value, period, mags, mag_v, mag_p


def _assert_counters(tstate, jstate, packed, mag_v, mag_p):
    """last_ts and exists equal; period, and value on slots synced once, as
    :func:`_assert_near_jax` allows. A slot with r > 1 adds may differ by
    that much more r spacings of max(|got|, |want|): the decayed values
    and counts are >= 0, so each add, in whichever order the scatter-add
    takes them, rounds by at most half a spacing of the final value."""
    for name in ("last_ts", "exists"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)))
    _assert_near_jax(tstate.period.numpy(), np.asarray(jstate.period), mag_p)
    got, want = tstate.value.numpy(), np.asarray(jstate.value)
    slots = packed[0][(packed[0] >= 0) & (packed[0] < len(got))]
    reps = np.bincount(slots, minlength=len(got))
    once = reps <= 1
    _assert_near_jax(got[once], want[once], mag_v[once])
    top = np.maximum(np.abs(got), np.abs(want))
    tol = (2 * np.spacing(np.maximum(top, mag_v)).astype(np.float64)
           + reps * np.spacing(top).astype(np.float64))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(err[~once] <= tol[~once]), (err - tol)[~once].max()


@pytest.mark.parametrize("rate", [3 / 1024, 0.37, 1e-4])
@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_sync_batch_packed_matches(seed, distinct, rate):
    s = _counter_state_np(N, seed)
    packed = _sync_operand(seed, distinct=distinct)
    jstate, jout = JK.sync_batch_packed(_counter_jax(s), jnp.asarray(packed),
                                        jnp.float32(rate))
    tstate = _counter_torch(s)
    out = ck.sync_counters(tstate, torch.from_numpy(packed), rate)
    want_out, want_value, want_period, mags, mag_v, mag_p = _sync_oracle(
        s, packed, rate)
    # Every row's reply is decayed + its own count (padding and
    # out-of-range rows read slot 0, as the JAX gather clamps them).
    _assert_near_jax(out.numpy(), np.asarray(jout), mags)
    _assert_counters(tstate, jstate, packed, mag_v, mag_p)
    # Against the separately rounded host oracle: replies and period equal,
    # value equal but for the order of duplicates' adds.
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_array_equal(tstate.period.numpy(), want_period)
    np.testing.assert_allclose(tstate.value.numpy(), want_value, atol=ATOL,
                               rtol=0)
    # Padding and out-of-range rows wrote nothing.
    touched = np.zeros(N, bool)
    valid = packed[0][(packed[0] >= 0) & (packed[0] < N)]
    touched[valid] = True
    np.testing.assert_array_equal(tstate.last_ts.numpy()[~touched],
                                  s[2][~touched])


def test_sync_duplicates_set_before_add():
    """Every duplicate reads the pre-sync state and every add lands after
    every set: a slot synced three times holds decayed + the three counts,
    and each reply is decayed + its own count."""
    s = _counter_state_np(8, 5)
    s[3][2] = True
    now = 60_000
    counts = np.array([1.5, 2.0, 4.25, 0.0], np.float32)
    packed = np.stack([np.array([2, 2, 2, -1], np.int32),
                       counts.view(np.int32), np.full(4, now, np.int32)])
    tstate = _counter_torch(s)
    out = ck.sync_counters(tstate, torch.from_numpy(packed), 0.01).numpy()
    delta = np.float32(max(0, now - int(s[2][2])))
    decayed = max(np.float32(0), s[0][2] - delta * np.float32(0.01))
    np.testing.assert_array_equal(out[0, :3], decayed + counts[:3])
    assert tstate.value[2].item() == decayed + np.float32(7.75)
    assert tstate.last_ts[2].item() == now and bool(tstate.exists[2])


@pytest.mark.parametrize("n", [4096, 70_000])
def test_sweep_counters_matches(n):
    now = 200_000_000
    rng = np.random.default_rng(n)
    s = (np.zeros(n, np.float32), np.zeros(n, np.float32),
         rng.integers(now - 2 * 86400 * 1024, now + 100, n).astype(np.int32),
         rng.random(n) < 0.5)
    _, jfreed = JK.sweep_counters(_counter_jax(s), jnp.int32(now))
    tstate = _counter_torch(s)
    mask, counts = ck.sweep_counters(tstate, now)
    assert mask.dtype == torch.int8 and counts.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy().astype(bool),
                                  np.asarray(jfreed))
    np.testing.assert_array_equal(tstate.exists.numpy(),
                                  s[3] & ~np.asarray(jfreed))
    padded = np.zeros(len(counts) * ck.TILE, np.int32)
    padded[:n] = np.asarray(jfreed)
    np.testing.assert_array_equal(counts.numpy(),
                                  padded.reshape(-1, ck.TILE).sum(1))
    assert 0 < int(counts.sum()) < int(s[3].sum())


def test_rebase_counter_epoch_matches():
    s = _counter_state_np(N, 9)
    jstate = JK.rebase_counter_epoch(_counter_jax(s), jnp.int32(40_000))
    tstate = TK.rebase_counter_epoch(_counter_torch(s), 40_000)
    for name in ("value", "period", "last_ts", "exists"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)))


def _c_entry_points():
    """Every ``extern "C"`` function of the kernel sources: ``{library:
    {name: [ctypes type per argument]}}``, read from the C prototypes."""
    import ctypes
    import re

    kinds = {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32,
             "int": ctypes.c_int32, "float": ctypes.c_float}
    out = {}
    for lib, src in ck._SOURCES.items():
        text = (ck.CSRC / src).read_text()
        for name, args in re.findall(
                r'extern "C" \w+ (drl_\w+)\(([^)]*)\)', text):
            types = []
            for arg in args.split(","):
                decl = arg.strip().rsplit(" ", 1)[0]
                types.append(ctypes.c_void_p
                             if "*" in arg or "cudaStream_t" in decl
                             else kinds[decl.replace("const ", "")])
            out.setdefault(lib, {})[name] = types
    return out


def test_bindings_match_the_c_prototypes():
    """Each library's ``ctypes`` signatures name every entry point of its
    source, with the prototype's argument count and kinds (a pointer or the
    stream as ``c_void_p``, ``int32_t`` / ``int64_t`` / ``float`` by
    width): a mismatch would pass a cut pointer or a shifted argument on
    the card, where no compiler sees both sides."""
    protos = _c_entry_points()
    assert set(protos) == set(ck._SIGNATURES)
    for lib, fns in ck._SIGNATURES.items():
        assert set(fns) == set(protos[lib]), lib
        for fn, argtypes in fns.items():
            assert list(argtypes) == protos[lib][fn], fn


@pytest.mark.parametrize("seed", range(3))
def test_scan_i32_lane_matches_jax_acquire_scan(seed):
    """The i32 lane of ``acquire_scan_packed`` (``kOpI32``: an ``i32[2, K,
    B]`` operand, padding rows' slots negative) against JAX's
    ``acquire_scan`` (i32 counts and an explicit ``valid``), which the JAX
    store launches for a bulk chunk whose count is above 255
    (``redis_tpu/runtime/store.py:1312``): a seeded chunk with counts up
    to 1,000, repeated slots within and across batches, padding rows and
    three ticks. Grants exact, remaining and state within ATOL."""
    cap = 1000.0
    s = _state_np(N, seed + 40)
    s = (s[0] * (cap / CAP), s[1], s[2])
    _operand, slots, counts, nows = _scan_case(seed + 900, False)
    assert (counts > 255).any()
    rate = 0.013
    jstate, jgranted, jremaining = JK.acquire_scan(
        _jax_state(s), jnp.asarray(slots), jnp.asarray(counts),
        jnp.asarray(slots >= 0), jnp.asarray(nows), jnp.float32(cap),
        jnp.float32(rate))
    tstate = _torch_state(s)
    operand = np.stack([slots, counts]).astype(np.int32)
    tout = ck.acquire_scan_packed(tstate, torch.from_numpy(operand),
                                  torch.from_numpy(nows), cap, rate)
    grants = np.asarray(jgranted).astype(np.float32)
    np.testing.assert_array_equal(tout[:, 0].numpy(), grants)
    np.testing.assert_allclose(tout[:, 1].numpy(), np.asarray(jremaining),
                               atol=ATOL, rtol=0)
    _assert_state(tstate, jstate)
    assert grants.sum() > 0 and (grants == 0).any()
