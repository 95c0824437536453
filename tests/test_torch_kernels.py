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


@pytest.mark.parametrize("n", [1, 64, 2**24, 2**24 + 12_345, 2**25,
                               2**25 + 1])
def test_scan_sort_bits_cover_table_and_padding_key(n):
    """The radix sort's bit range follows N (a grown or restored table need
    not be a power of two): slots 0 … N-1 and the padding key N fit, and
    one bit fewer would not hold the padding key."""
    bits = ck.scan_sort_bits(n)
    assert n < 2**bits            # slots 0 … N-1 and the padding key N
    assert n >= 2 ** (bits - 1)   # no wasted radix pass


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
    assert set(ck.launches) == {"sweep_expired", "acquire_packed",
                                "acquire_grouped", "acquire_scan"}
    assert all(v == 0 for v in ck.launches.values())
