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
