"""The mesh's kernels and stores on the card against their plain versions.

These tests need an NVIDIA GPU and ``nvcc`` and skip without one. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

- ``global_tier`` (``csrc/mesh.cu``) against its plain version at K = 1, 8
  and 32 batches of up to 8 x 1,024 rows, both cadences, fresh and live
  counters, a clock going back: equal bit for bit (whole counts: every
  total is an exact integer, rounded once on both sides; the recurrence
  rounds each operation as the plain version's separate float32 ops do).
- The fingerprint kernels with 8 shard regions against their plain
  versions, compared by key (``find_np`` with the regions): the winner of
  a contested cell is the atomics' order on the card.
- The sharded stores on a mesh of 8 x ``cuda`` against the same stores on
  8 x ``cpu`` (the plain versions), on the same keys and clock: grants,
  remaining (atol 1e-4), peeks and the global score equal.
"""

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.parallel import fp_sharded as PS
from distributedratelimiting.redis_tpu_torch.parallel import sharded_store as P
from distributedratelimiting.redis_tpu_torch.parallel.mesh import Mesh
from distributedratelimiting.redis_tpu_torch.runtime.clock import ManualClock

pytestmark = pytest.mark.cuda

S = 8
ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _counter(dev, live, rng):
    g = K.init_global_counter(dev)
    if live:
        g.value.fill_(float(rng.integers(0, 100_000)))
        g.period.fill_(812.375)
        g.last_ts.fill_(40_000)
        g.exists.fill_(True)
    return g


@pytest.mark.parametrize("cadence", ["batch", "launch"])
@pytest.mark.parametrize("k,r", [(1, 8), (1, 8192), (8, 4096), (32, 1024)])
def test_global_tier_equals_plain(cuda_device, k, r, cadence):
    rng = np.random.default_rng(k * 7 + r)
    out = np.zeros((k, 2, r), np.float32)
    out[:, 0] = rng.random((k, r)) < 0.7
    out[:, 0] += 2.0 * (rng.random((k, r)) < 0.5)  # an fp code's bit 1
    counts = rng.integers(0, 2000, (k, r)).astype(np.int32)
    nows = (41_000 + np.cumsum(rng.integers(0, 900, k))).astype(np.int32)
    if k > 2:
        nows[1] = nows[0] - 5
    for live in (False, True):
        for rate in (0.0, 0.37, 1.0 / 1024):
            gc = _counter("cpu", live, np.random.default_rng(1))
            gd = _counter(cuda_device, live, np.random.default_rng(1))
            K.global_tier(torch.from_numpy(out), torch.from_numpy(counts),
                          torch.from_numpy(nows), gc, rate, cadence)
            before = ck.launches["global_tier"]
            ck.global_tier(torch.from_numpy(out).to(cuda_device),
                           torch.from_numpy(counts).to(cuda_device),
                           torch.from_numpy(nows).to(cuda_device), gd, rate,
                           cadence)
            torch.cuda.synchronize()
            assert ck.launches["global_tier"] == before + 1
            for a, b in zip(gc, gd):
                assert a.item() == b.cpu().item(), (live, rate)


def test_global_tier_checks_its_operands(cuda_device):
    g = K.init_global_counter(cuda_device)
    with pytest.raises(ValueError, match="counts"):
        ck.global_tier(torch.zeros((2, 2, 8), device=cuda_device),
                       torch.zeros((2, 9), dtype=torch.int32,
                                   device=cuda_device),
                       torch.zeros((2,), dtype=torch.int32,
                                   device=cuda_device), g, 0.0)
    with pytest.raises(ValueError, match="must lie on a CUDA device"):
        ck.global_tier(torch.zeros((1, 2, 8)),
                       torch.zeros((1, 8), dtype=torch.int32),
                       torch.zeros((1,), dtype=torch.int32), g, 0.0)


def _routed(rng, m):
    fps = rng.integers(1, 2**32, (S * m * 4, 2), dtype=np.uint64).astype(
        np.uint32)
    out = np.zeros((S, m, 2), np.uint32)
    for s in range(S):
        out[s] = fps[fps[:, 0] % S == s][:m]
    return out


def test_fp_kernels_with_shard_regions_equal_plain_by_key(cuda_device):
    rng = np.random.default_rng(3)
    per, L, k, b = 1 << 14, 16, 4, 512
    keys = _routed(rng, 600)
    fused = np.zeros((S, k, b, 3), np.uint32)
    idx = rng.integers(0, 600, (S, k, b))
    for s in range(S):
        fused[s, ..., :2] = keys[s][idx[s]]
    fused[..., 2] = rng.integers(0, 3, (S, k, b)).astype(np.uint32)
    fused[rng.random((S, k, b)) < 0.05, 2] = np.uint32(0xFFFFFFFF)
    rows = np.ascontiguousarray(fused.transpose(1, 0, 2, 3)).reshape(
        k, S * b, 3).view(np.int32)
    nows = np.array([50_000, 50_100, 50_100, 51_000], np.int32)
    cpu = (F.init_fp_table(S * per), K.init_bucket_state(S * per))
    dev = (F.init_fp_table(S * per, cuda_device),
           K.init_bucket_state(S * per, cuda_device))
    outs = []
    for fp, st in (cpu, dev):
        d = fp.device
        out, counts = ck.fp_acquire_scan(
            fp, st, torch.from_numpy(rows).to(d),
            torch.from_numpy(nows).to(d), 5.0, 0.01, probe_window=L,
            n_shards=S, return_counts=True)
        outs.append((out.cpu().numpy(), counts.cpu().numpy()))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(outs[0][0][:, 0], outs[1][0][:, 0])
    np.testing.assert_allclose(outs[0][0][:, 1], outs[1][0][:, 1], atol=ATOL)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    live = keys.reshape(-1, 2)
    tables = [fp.cpu().numpy().view(np.uint32) for fp, _ in (cpu, dev)]
    cells = [F.find_np(t, live, L, S) for t in tables]
    np.testing.assert_array_equal(cells[0] >= 0, cells[1] >= 0)
    assert (cells[1][cells[1] >= 0] // per
            == (live[:, 0] % S)[cells[1] >= 0]).all()
    F.check_table_np(tables[1], L, S)
    hit = cells[0] >= 0
    for f in ("tokens", "last_ts", "exists"):
        a = getattr(cpu[1], f).numpy()[cells[0][hit]]
        c = getattr(dev[1], f).cpu().numpy()[cells[1][hit]]
        np.testing.assert_allclose(a.astype(np.float64), c.astype(np.float64),
                                   atol=ATOL)
    # The peek and the migrate in the regions, by key: 8 keys a shard.
    sample = np.ascontiguousarray(keys[:, :8].reshape(-1, 2))
    kp = torch.from_numpy(sample.view(np.int32))
    valid = torch.ones(64, dtype=torch.bool)
    pc = ck.fp_peek(*cpu, kp, valid, 52_000, 5.0, 0.01, probe_window=L,
                    n_shards=S)
    pd = ck.fp_peek(*dev, kp.to(cuda_device), valid.to(cuda_device), 52_000,
                    5.0, 0.01, probe_window=L, n_shards=S)
    np.testing.assert_array_equal(pc.numpy(), pd.cpu().numpy())
    new = (F.init_fp_table(S * 64, cuda_device),
           K.init_bucket_state(S * 64, cuda_device))
    cols = [torch.ones(64, device=cuda_device),
            torch.full((64,), 7, dtype=torch.int32, device=cuda_device),
            torch.ones(64, dtype=torch.bool, device=cuda_device)]
    placed = ck.fp_migrate(*new, kp.to(cuda_device), cols,
                           valid.to(cuda_device), probe_window=L, n_shards=S)
    assert placed.all()
    found = F.find_np(new[0].cpu().numpy().view(np.uint32), sample, L, S)
    assert (found >= 0).all() and (found // 64 == sample[:, 0] % S).all()


def _stores(mesh_dev, mesh_cpu, cls, **kw):
    return (cls(mesh_dev, clock=ManualClock(start_ticks=5_000), **kw),
            cls(mesh_cpu, clock=ManualClock(start_ticks=5_000), **kw))


@pytest.mark.parametrize("kind", ["host", "fp", "window", "fp_window"])
@pytest.mark.parametrize("cadence", ["batch", "launch"])
def test_sharded_stores_on_the_card_equal_the_cpu(cuda_device, kind,
                                                  cadence):
    dm, cm = Mesh([cuda_device] * S), Mesh(["cpu"] * S)
    if kind == "host":
        a, b = _stores(dm, cm, P.ShardedDeviceStore, capacity=6.0,
                       fill_rate_per_sec=2.0, per_shard_slots=256,
                       sync_cadence=cadence)
    elif kind == "fp":
        a, b = _stores(dm, cm, PS.ShardedFpDeviceStore, capacity=6.0,
                       fill_rate_per_sec=2.0, per_shard_slots=4096,
                       decay_rate_per_sec=1.0, sync_cadence=cadence)
    elif kind == "window":
        a, b = _stores(dm, cm, P.ShardedWindowStore, limit=6.0,
                       window_sec=1.0, per_shard_slots=256)
    else:
        a, b = _stores(dm, cm, PS.ShardedFpWindowStore, limit=6.0,
                       window_sec=1.0, per_shard_slots=4096)
    rng = np.random.default_rng(17)
    keys = [f"m{i}" for i in range(3000)]
    for step in range(6):
        for s in (a, b):
            s.clock.advance_ticks(300 * step)
        m = int(rng.integers(100, 6000))
        ks = [keys[i] for i in rng.integers(0, len(keys), m)]
        cs = [int(c) for c in rng.integers(0, 4, m)]
        ra = a.acquire_many_blocking(ks, cs)
        rb = b.acquire_many_blocking(ks, cs)
        np.testing.assert_array_equal(ra.granted, rb.granted)
        np.testing.assert_allclose(ra.remaining, rb.remaining, atol=ATOL)
        if kind in ("host", "fp"):
            assert a.global_score == b.global_score
            for k in ks[:20]:
                assert a.peek_blocking(k) == b.peek_blocking(k)
        sa = a.acquire_batch_blocking(list(zip(ks[:50], cs)))
        sb = b.acquire_batch_blocking(list(zip(ks[:50], cs)))
        assert [r.granted for r in sa] == [r.granted for r in sb]
    assert a.sweep() == b.sweep()


def test_mesh_over_two_cards_raises(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    with pytest.raises(ValueError, match="A 16"):
        Mesh(["cuda:0", "cuda:1"])
