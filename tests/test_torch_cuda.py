"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no CPU mode)
and skip without one. This file imports neither JAX nor the JAX package, so
it runs on a machine without JAX; there, skip the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in ``test_torch_kernels.py``: grants, bits, masks, ``exists``
and ``last_ts`` equal; remaining and tokens within atol 1e-4 (the flush
kernels add duplicates' consumption with atomics in no fixed order; the scan
kernel subtracts each slot's int64 sum once, where the plain version
subtracts row by row).
"""

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


@pytest.mark.cuda
@pytest.mark.parametrize("b", [B, 5000])  # one round of rows, and two
@pytest.mark.parametrize("rows,wrapper", [(4, ck.acquire_packed),
                                          (5, ck.acquire_grouped)])
def test_acquire_kernels_match_plain(cuda_device, rows, wrapper, b):
    plain, card = _state(1, cuda_device)
    op = _operand(2, rows, b)
    before = dict(ck.launches)
    want = wrapper(plain, op, CAP, 0.013)
    got = wrapper(card, op.to(cuda_device), CAP, 0.013)
    torch.cuda.synchronize()
    _assert_same(card, plain, got, want)
    name = "acquire_packed" if rows == 4 else "acquire_grouped"
    assert ck.launches[name] == before[name] + 1  # one launch per call
    assert sum(ck.launches.values()) == sum(before.values()) + 1


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
