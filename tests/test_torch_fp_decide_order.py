"""The fingerprint decision's flush form, its decomposition, on the CPU.

At K = 1 and B <= 4096 the card decides a batch of keys in ONE launch
(``csrc/decide.cuh``: ``fp_flush_warp_kernel`` up to 32 rows, else
``fp_flush_block_kernel`` on ``launch_blocks(B)`` blocks of 1024 threads):

- partition: a valid row goes to the block of a hash of its key's 31-bit
  mix ``((lo * MIX) ^ hi) >> 1`` (never the padding key), a padding row to
  block ``r mod G``; so every row of a key, and so of its cell, meets in
  one block, and a block keeps its rows in request order;
- probe: each warp probes its positions ``p = j * 1024 + lane * 32 +
  warp`` with the group probe, the rows of one key in a warp once; the
  warps run in whatever order the card's atomics give (emulated here by a
  seeded shuffle of the probe steps), each key a find-or-claim over its
  window: a hit, else the first empty cell in its rotation from ``pref``,
  else unresolved;
- decision: a live row's prefix is the int64 sum of the counts of the
  earlier live rows of its cell (request order), converted once to
  float32; the cell's one writer stores the advanced state with the int64
  sum of its granted counts; row 0 of the result is ``grant + 2 x
  resolved`` (padding counts as resolved).

This file emulates that decomposition in numpy and holds it against the
JAX package's ``fp_acquire_batch`` / ``fp_window_acquire_batch`` (sliding
and fixed, ``handle_duplicates=True``) and the port's plain versions, on
seeded inputs with keys repeated within a warp, across warps and across
blocks, and padding rows, at B in {8, 32, 33, 64, 256, 257, 1024, 4096}
(warp, one block, several blocks). The tables are sparse (no window
pressure), so every row resolves on every side.

Tolerance: results and state compare by key (which cell a new key wins
depends on the claim order), bit for bit: counts are whole and below 2^24,
the fill rate and window are powers of two, so a grant's balance and the
one writer's int64 sum are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.ops import fp_directory as JF
from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
from distributedratelimiting.redis_tpu_torch.ops import kernels as K

EMPTY = np.uint32(0xFFFFFFFF)
L = 16
N = 1 << 14
NOW = 50_000
CAP = 10.0
RATE = 1.0 / 1024.0
LIMIT = 6.0
WINDOW = 1024
f32 = np.float32


def _fps(rng, m):
    return rng.integers(1, 2**32, (m, 2), dtype=np.uint64).astype(np.uint32)


def launch_blocks(b):
    return 1 if b <= 256 else min(64, b // 64)


def partition(rows, valid, g):
    """Each row's block: a hash of its key's 31-bit mix (a padding row by
    its index), as ``fp_flush_block_kernel`` and batch.cuh's block_of."""
    mix = ((rows[:, 0].astype(np.uint64) * np.uint64(F.MIX))
           & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ rows[:, 1]
    key = np.where(valid, mix >> np.uint32(1), EMPTY)
    assert (key[valid] != EMPTY).all()
    h = ((key.astype(np.uint64) * np.uint64(2654435761))
         & np.uint64(0xFFFFFFFF)) >> np.uint64(7)
    return np.where(key != EMPTY, (h % np.uint64(g)).astype(np.int64),
                    np.arange(len(rows)) % g)


def find_or_claim(cells, key, base, pref):
    win = cells[base:base + L]
    hit = np.nonzero(win == key)[0]
    if len(hit):
        return base + int(hit[0])
    order = (pref + np.arange(L)) % L
    free = order[(win == 0)[order]]
    if not len(free):
        return -1
    cells[base + free[0]] = key
    return base + int(free[0])


def probe(cells, rows, valid, blocks, b, rng):
    """Every row's cell (-1: padding or unresolved) from the card's probe
    units (a warp's positions at one j), run in a seeded order."""
    key64 = np.ascontiguousarray(rows).view(np.uint64).reshape(-1)
    base = F.base_index_np(rows, len(cells), L)
    pref = F.pref_index_np(rows, L)
    units = []
    if b <= 32:
        rpw = 32 // (L // 4)  # rows a warp probes in one step
        units = [list(range(s, min(s + rpw, b))) for s in range(0, b, rpw)]
    else:
        for blk in range(max(blocks) + 1):
            own = np.nonzero(blocks == blk)[0]  # request order
            for j in range(-(-len(own) // 1024)):
                for w in range(32):
                    ps = [j * 1024 + lane * 32 + w for lane in range(32)]
                    units.append([int(own[p]) for p in ps if p < len(own)])
    slot = np.full(b, -1, np.int64)
    for u in rng.permutation(len(units)):
        seen = {}
        for r in units[u]:
            if not valid[r]:
                continue
            if key64[r] not in seen:  # one probe a key a warp
                seen[key64[r]] = find_or_claim(cells, key64[r], base[r],
                                               pref[r])
            slot[r] = seen[key64[r]]
    return slot


def decide(kind, state, slot, counts, valid, blocks, interpolate=True):
    """The card's decision over its cells, block by block in request order:
    a row's prefix the int64 sum of its cell's earlier live counts, each
    cell committed once with the int64 sum of its grants."""
    b = len(slot)
    live = slot >= 0
    gs = torch.from_numpy(np.where(live, slot, 0))
    if kind == "bucket":
        ref = bm.refill_or_init(state.tokens[gs], state.last_ts[gs],
                                state.exists[gs], NOW, CAP, RATE).numpy()
        room = ref
    else:
        prev, curr, idx = bm.sliding_window_advance(
            state.prev_count[gs], state.curr_count[gs],
            state.window_idx[gs], state.exists[gs], NOW, WINDOW)
        est = (bm.sliding_window_estimate(prev, curr, idx, NOW, WINDOW)
               if interpolate else curr).numpy()
        room = f32(LIMIT) - est
    granted = np.zeros(b, bool)
    remaining = np.zeros(b, f32)
    used = {}
    for blk in range(max(blocks) + 1):
        run = {}
        for r in np.nonzero(blocks == blk)[0]:
            if not live[r]:
                continue
            s, c = int(slot[r]), int(counts[r])
            pre = f32(run.get(s, 0))
            run[s] = run.get(s, 0) + c
            if kind == "bucket":
                ok = ref[r] >= pre + f32(c)
            else:
                ok = (est[r] + pre) + f32(c) <= f32(LIMIT)
            granted[r] = ok
            remaining[r] = max((room[r] - pre) - (f32(c) if ok else f32(0)),
                               f32(0))
            used.setdefault(s, [r, 0])[1] += c if ok else 0
    for s, (r, u) in used.items():  # one writer a cell
        if kind == "bucket":
            state.tokens[s] = float(ref[r] - f32(u))
            state.last_ts[s] = NOW
        else:
            state.prev_count[s] = prev[r]
            state.curr_count[s] = float(curr[r].numpy() + f32(u))
            state.window_idx[s] = idx[r]
        state.exists[s] = True
    return granted, remaining


def _tables(rng, kind, present):
    keys = _fps(rng, present)
    jfp = JF.fp_resolve_core(JF.init_fp_table(N), jnp.asarray(keys),
                             jnp.ones(present, bool), probe_window=L,
                             rounds=4).fp
    live = (np.asarray(jfp) != 0).any(1)
    if kind == "bucket":
        cols = [rng.uniform(0, CAP, N).astype(f32),
                rng.integers(NOW - 3000, NOW + 50, N).astype(np.int32),
                rng.random(N) < 0.7]
    else:
        cols = [rng.integers(0, 4, N).astype(f32),
                rng.integers(0, 4, N).astype(f32),
                rng.integers(NOW // WINDOW - 3, NOW // WINDOW + 1,
                             N).astype(np.int32),
                rng.random(N) < 0.7]
    for c in cols:
        c[~live] = 0  # an empty cell holds no state
    jcls = JK.BucketState if kind == "bucket" else JK.WindowState
    pcls = K.BucketState if kind == "bucket" else K.WindowState
    return (keys, (jfp, jcls(*(jnp.asarray(c) for c in cols))),
            (torch.from_numpy(np.array(jfp).view(np.int32)),
             pcls(*(torch.from_numpy(c.copy()) for c in cols))))


def _by_key(keys, fp_a, st_a, fp_b, st_b):
    """Each key in both tables or neither, its state equal."""
    sa = F.find_np(np.asarray(fp_a), keys, L)
    sb = F.find_np(np.asarray(fp_b), keys, L)
    np.testing.assert_array_equal(sa >= 0, sb >= 0)
    hit = sa >= 0
    for name, a, b in zip(st_b._fields, st_a, st_b):
        np.testing.assert_array_equal(np.asarray(b)[sb[hit]],
                                      np.asarray(a)[sa[hit]], name)


@pytest.mark.parametrize("kind", ["bucket", "sliding", "fixed"])
@pytest.mark.parametrize("b", [8, 32, 33, 64, 256, 257, 1024, 4096])
def test_flush_form_matches_jax_and_plain(kind, b):
    rng = np.random.default_rng(b * 7 + len(kind))
    table = "bucket" if kind == "bucket" else "window"
    keys, (jfp, jst), (pfp, pst) = _tables(rng, table, 1500)
    # Few distinct keys: repeats within a warp, across warps and blocks.
    pool = np.concatenate([keys[:max(2, b // 8)], _fps(rng, max(2, b // 8))])
    rows = pool[rng.integers(0, len(pool), b)]
    counts = rng.integers(0, 4, b).astype(np.int32)
    valid = rng.random(b) < 0.9
    counts[~valid] = 0
    interp = kind != "fixed"

    # The emulation, on a numpy copy of the port's table.
    cells = pfp.numpy().view(np.uint64).reshape(-1).copy()
    est = type(pst)(*(t.clone() for t in pst))
    g = launch_blocks(b) if b > 32 else 1
    blocks = partition(rows, valid, g)
    slot = probe(cells, rows, valid, blocks, b, rng)
    assert (slot[valid] >= 0).all()
    eg, erem = decide(table, est, slot, counts, valid, blocks, interp)
    ecode = eg + 2.0 * np.ones(b)

    # JAX, and the port's plain version.
    args = (jnp.asarray(rows), jnp.asarray(counts), jnp.asarray(valid),
            jnp.int32(NOW))
    pargs = (torch.from_numpy(rows.view(np.int32)), torch.from_numpy(counts),
             torch.from_numpy(valid), NOW)
    if table == "bucket":
        jfp, jst, jg, jr, jres = JF.fp_acquire_batch(
            jfp, jst, *args, jnp.float32(CAP), jnp.float32(RATE))
        _, _, pg, pr, pres = F.fp_acquire_batch(pfp, pst, *pargs, CAP, RATE)
    else:
        jfp, jst, jg, jr, jres = JF.fp_window_acquire_batch(
            jfp, jst, *args, jnp.float32(LIMIT), WINDOW, interpolate=interp)
        _, _, pg, pr, pres = F.fp_window_acquire_batch(
            pfp, pst, *pargs, LIMIT, WINDOW, interpolate=interp)
    for g_, r_, res in ((np.asarray(jg), np.asarray(jr), np.asarray(jres)),
                        (pg.numpy(), pr.numpy(), pres.numpy())):
        assert res.all()
        np.testing.assert_array_equal(g_ + 2.0 * res, ecode)
        np.testing.assert_array_equal(r_, erem)
    allk = np.concatenate([keys, rows])
    emu_fp = cells.view(np.uint32).reshape(-1, 2)
    _by_key(allk, np.asarray(jfp), jst, emu_fp, est)
    _by_key(allk, pfp.numpy().view(np.uint32), pst, emu_fp, est)
    F.check_table_np(emu_fp, L)


@pytest.mark.parametrize("b", [33, 257, 4096])
def test_partition_keeps_keys_together_and_request_order(b):
    """Every row of a key goes to one block, padding rows spread by index,
    and each block's rows keep request order (``own_rows``)."""
    rng = np.random.default_rng(b)
    pool = _fps(rng, max(4, b // 16))
    rows = pool[rng.integers(0, len(pool), b)]
    valid = rng.random(b) < 0.9
    g = launch_blocks(b)
    blocks = partition(rows, valid, g)
    key64 = rows.view(np.uint64).reshape(-1)
    for k in np.unique(key64[valid]):
        assert len(np.unique(blocks[valid & (key64 == k)])) == 1
    np.testing.assert_array_equal(blocks[~valid], np.nonzero(~valid)[0] % g)
    assert 0 <= blocks.min() and blocks.max() < g
