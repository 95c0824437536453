"""The PyTorch port's bucket math against the JAX package's, on seeded
inputs made with numpy. Integer results are compared exactly; the float32
refill to within one ulp (the two frameworks may round a product and a sum
differently only if one of them fuses them)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributedratelimiting.redis_tpu.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import bucket_math as tbm

# Small tensors: one intra-op thread, so that parallel test workers keep
# their cores.
torch.set_num_threads(1)


def _state(n, seed, cap=100.0):
    rng = np.random.default_rng(seed)
    tokens = rng.uniform(0, cap, n).astype(np.float32)
    last_ts = rng.integers(0, 50_000, n).astype(np.int32)
    exists = rng.random(n) < 0.7
    return tokens, last_ts, exists


def _ulp_close(a, b, ulps=1):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.all(np.abs(a - b) <= ulps * np.spacing(np.maximum(np.abs(a),
                                                                np.abs(b))))


def test_constants_are_copied_not_imported():
    assert tbm.TICKS_PER_SECOND == bm.TICKS_PER_SECOND
    assert tbm.MIN_TTL_TICKS == bm.MIN_TTL_TICKS
    assert tbm.MAX_TTL_TICKS == bm.MAX_TTL_TICKS


@pytest.mark.parametrize("now", [0, 10_000, 60_000])
def test_elapsed_ticks_clamps_clock_regression(now):
    _, last_ts, _ = _state(512, seed=now)
    ref = np.asarray(bm.elapsed_ticks(now, jnp.asarray(last_ts)))
    got = tbm.elapsed_ticks(now, torch.from_numpy(last_ts)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).all()  # a clock behind last_ts mints nothing


@pytest.mark.parametrize("rate", [10 / 1024, 0.37, 1e-4])
def test_refill_within_one_ulp(rate):
    tokens, last_ts, _ = _state(2048, seed=7)
    now = 40_000
    ref = np.asarray(bm.refill(jnp.asarray(tokens), jnp.asarray(last_ts),
                               now, 100.0, rate))
    got = tbm.refill(torch.from_numpy(tokens), torch.from_numpy(last_ts),
                     now, 100.0, rate).numpy()
    assert _ulp_close(got, ref)
    assert (got <= 100.0).all()


def test_refill_or_init_fills_missing_slots():
    tokens, last_ts, exists = _state(1024, seed=3)
    now, rate = 30_000, 5 / 512
    ref = np.asarray(bm.refill_or_init(
        jnp.asarray(tokens), jnp.asarray(last_ts), jnp.asarray(exists), now,
        100.0, rate))
    got = tbm.refill_or_init(
        torch.from_numpy(tokens), torch.from_numpy(last_ts),
        torch.from_numpy(exists), now, 100.0, rate).numpy()
    # Dyadic rate: every product and sum is exact, so results are equal.
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[~exists], 100.0)


@pytest.mark.parametrize("rate", [0.0, 1e-9, 1e-3, 0.5, 10 / 1024])
def test_time_to_full_ttl_matches_and_saturates(rate):
    tokens, _, _ = _state(2048, seed=11)
    tokens[:4] = [100.0, 0.0, -5e9, 99.999]  # full, empty, huge deficit
    ref = np.asarray(bm.time_to_full_ttl(jnp.asarray(tokens), 100.0, rate))
    got = tbm.time_to_full_ttl(torch.from_numpy(tokens), 100.0, rate).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (got >= bm.MIN_TTL_TICKS).all()


def test_ttl_saturation_trap():
    """f32 2^31 → int32: XLA saturates to 2^31 - 1, a plain torch cast
    gives -2^31 (and every slot would expire). The port saturates."""
    tokens = torch.zeros(8)
    ttl = tbm.time_to_full_ttl(tokens, 100.0, 0.0)
    assert (ttl == 2**31 - 1).all()
    naive = torch.clamp(torch.full((1,), 1e32), 1024, 2**31 - 1)
    assert naive.to(torch.int32).item() != 2**31 - 1  # the trap is real


@pytest.mark.parametrize("seed", range(4))
def test_duplicate_prefix_exact(seed):
    rng = np.random.default_rng(seed)
    b = 256
    slots = rng.integers(-1, 12, b).astype(np.int32)  # heavy duplicates
    counts = rng.integers(0, 9, b).astype(np.int32)
    valid = (slots >= 0) & (rng.random(b) < 0.9)
    ref = np.asarray(bm.duplicate_prefix(jnp.asarray(slots),
                                         jnp.asarray(counts),
                                         jnp.asarray(valid)))
    got = tbm.duplicate_prefix(torch.from_numpy(slots),
                               torch.from_numpy(counts),
                               torch.from_numpy(valid)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_duplicate_prefix_integer_exact_past_2_24():
    # One hot slot whose running demand passes 2^24: the int64 segmented
    # sum stays exact where a float32 running sum would round.
    slots = torch.zeros(6, dtype=torch.int32)
    counts = torch.full((6,), 2**22 + 1, dtype=torch.int32)
    got = tbm.duplicate_prefix(slots, counts, torch.ones(6, dtype=torch.bool))
    want = np.arange(6, dtype=np.int64) * (2**22 + 1)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def _counter_np(n, seed, now):
    """Counter state with live and fresh slots, timestamps ahead of ``now``
    (a clock regression) and long before it (deltas past 2^24 ticks)."""
    rng = np.random.default_rng(seed)
    value = rng.uniform(0, 1000, n).astype(np.float32)
    period = rng.uniform(0, 5000, n).astype(np.float32)
    last_ts = rng.integers(max(now - 3000, 0), now + 500, n).astype(np.int32)
    last_ts[rng.random(n) < 0.2] = max(now - 2**25 - 17, 0)
    exists = rng.random(n) < 0.6
    return value, period, last_ts, exists


def test_counter_constants_are_copied():
    assert tbm.GLOBAL_COUNTER_TTL_TICKS == bm.GLOBAL_COUNTER_TTL_TICKS
    assert tbm.PERIOD_EWMA_ALPHA == bm.PERIOD_EWMA_ALPHA


@pytest.mark.parametrize("rate", [3 / 1024, 0.37, 1e-4, 0.0])
@pytest.mark.parametrize("now", [0, 50_000, 2**25 + 7, 2**30])
def test_decay_core_and_add_exact(now, rate):
    v, p, ts, ex = _counter_np(4096, now % 97, now)
    counts = np.random.default_rng(1).uniform(0, 50, 4096).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (v, p, ts, ex)]
    targs = [torch.from_numpy(a) for a in (v, p, ts, ex)]
    for got, want in zip(tbm.decay_core(*targs, now, rate),
                         bm.decay_core(*jargs, now, rate)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tbm.decay_and_add(*targs, now, torch.from_numpy(counts), rate)
    want = bm.decay_and_add(*jargs, now, jnp.asarray(counts), rate)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    decayed, period = tbm.decay_core(*targs, now, rate)
    # A fresh counter decays from nothing, and its EWMA starts at delta.
    assert (decayed.numpy()[~ex] == 0).all()
    np.testing.assert_array_equal(period.numpy()[~ex], np.float32(now))


@pytest.mark.parametrize("period_ticks", [1024, 4096.0, 10 * 1024])
def test_instance_count_estimate_exact(period_ticks):
    p = np.random.default_rng(2).uniform(0, 20_000, 2048).astype(np.float32)
    p[:4] = [0.0, 0.5, 512.0, 1536.0]  # clamp at 1; round half to even
    want = np.asarray(bm.instance_count_estimate(period_ticks,
                                                 jnp.asarray(p)))
    got = tbm.instance_count_estimate(period_ticks, torch.from_numpy(p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("limit", [10, 100, 5000])
def test_available_tokens_exact(limit):
    rng = np.random.default_rng(limit)
    g = rng.uniform(0, 2 * limit, 1024).astype(np.float32)
    k = rng.integers(0, 9, 1024).astype(np.int32)  # 0 clamps to 1
    local = rng.uniform(0, limit / 4, 1024).astype(np.float32)
    want = np.asarray(bm.available_tokens(limit, jnp.asarray(g),
                                          jnp.asarray(k), jnp.asarray(local)))
    got = tbm.available_tokens(limit, torch.from_numpy(g),
                               torch.from_numpy(k), torch.from_numpy(local))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).all()


@pytest.mark.parametrize("rate", [0.37, 1e-4, 0.0])
def test_retry_after_ticks_exact_and_saturating(rate):
    d = np.random.default_rng(3).uniform(-100, 1e6, 1024).astype(np.float32)
    want = np.asarray(bm.retry_after_ticks(jnp.asarray(d), rate))
    got = tbm.retry_after_ticks(torch.from_numpy(d), rate)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
