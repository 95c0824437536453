"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no CPU mode)
and skip without one. This file imports neither JAX nor the JAX package, so
it runs on a machine without JAX; there, skip the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in ``test_torch_kernels.py``: grants, masks, ``exists`` and
``last_ts`` equal; remaining and tokens within atol 1e-4 (duplicates'
consumption is added by atomics in no fixed order).
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


def _operand(seed, rows, now=50_000):
    rng = np.random.default_rng(seed)
    slots = np.minimum(rng.zipf(1.3, B) - 1, N - 1).astype(np.int32)
    slots[rng.random(B) < 0.1] = -1
    slots[rng.random(B) < 0.05] = N + 3
    counts = rng.integers(0, 4, B).astype(np.int32)
    sizes = rng.integers(1, 6, B).astype(np.int32)
    valid = torch.from_numpy((slots >= 0) & (slots < N))
    demand = counts * sizes if rows == 5 else counts
    prefix = bm.duplicate_prefix(torch.from_numpy(slots),
                                 torch.from_numpy(demand), valid)
    out = [slots, counts, np.full(B, now, np.int32),
           prefix.numpy().astype(np.int32), sizes]
    return torch.from_numpy(np.stack(out[:rows]))


def _assert_same(card, plain, card_out, plain_out):
    np.testing.assert_array_equal(card_out[0].cpu().numpy(),
                                  plain_out[0].numpy())
    np.testing.assert_allclose(card_out[1].cpu().numpy(),
                               plain_out[1].numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(card.tokens.cpu().numpy(),
                               plain.tokens.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(card.last_ts.cpu().numpy(),
                                  plain.last_ts.numpy())
    np.testing.assert_array_equal(card.exists.cpu().numpy(),
                                  plain.exists.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,wrapper", [(4, ck.acquire_packed),
                                          (5, ck.acquire_grouped)])
def test_acquire_kernels_match_plain(cuda_device, rows, wrapper):
    plain, card = _state(1, cuda_device)
    op = _operand(2, rows)
    before = dict(ck.launches)
    want = wrapper(plain, op, CAP, 0.013)
    got = wrapper(card, op.to(cuda_device), CAP, 0.013)
    torch.cuda.synchronize()
    _assert_same(card, plain, got, want)
    name = "acquire_packed" if rows == 4 else "acquire_grouped"
    assert ck.launches[name] == before[name] + 1


@pytest.mark.cuda
def test_scan_lane_matches_plain(cuda_device):
    plain, card = _state(3, cuda_device)
    rng = np.random.default_rng(4)
    slots = np.minimum(rng.zipf(1.3, (3, B)) - 1, N - 1).astype(np.int32)
    counts = rng.integers(0, 4, (3, B)).astype(np.int32)
    nows = torch.tensor([50_000, 50_300, 51_000], dtype=torch.int32)
    want = ck.acquire_scan_packed(plain, torch.from_numpy(slots),
                                  torch.from_numpy(counts), nows, CAP, 0.013)
    got = ck.acquire_scan_packed(card, torch.from_numpy(slots).to(cuda_device),
                                 torch.from_numpy(counts).to(cuda_device),
                                 nows.to(cuda_device), CAP, 0.013)
    torch.cuda.synchronize()
    _assert_same(card, plain, got.transpose(0, 1), want.transpose(0, 1))


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
