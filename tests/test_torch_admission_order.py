"""The semaphore and two-level admission kernels' decomposition, on the CPU.

The card's kernels (``csrc/sema.cu``, ``csrc/admission.cu``, on
``csrc/batch.cuh``) do not sort every batch by slot, as the plain versions
(``K.sema_batch_packed``, ``K.acquire_hierarchical_packed``) do. A batch
of B rows takes one of two paths:

- warp (B <= 32): row = lane. A row's same-slot peers are the lanes with its
  key (``__match_any_sync``); lane order is request order, so its exclusive
  prefix is the sum over its lower-lane peers, and the highest peer writes
  the slot with the sum over all of them;
- block (33 <= B <= 4096; above 256 rows spread over min(64, B / 64)
  blocks, each taking the rows of its share of the slots — for the
  two-level kernel of the tenants, unless a key's rows fall under two
  blocks or every tenant goes to one block, when one block takes them all —
  and deciding them as one batch in request order): a hash set finds the
  slots that repeat. With none
  every prefix is 0 and every row writes its own slot. Otherwise each
  repeated slot takes a compact id, in whatever order the hardware's
  atomics give (emulated here by a seeded permutation); rows are sorted
  stably by id with a 4-bit LSD radix sort over bit_length(ids) bits, the
  lone rows (key = number of ids) after them, each its own segment; int64
  segmented scans give the prefixes, and each slot's last row in that
  order (its last in request order) writes it with the int64 sum of its
  rows' applied deltas or consumption.

This file emulates that decomposition in numpy and holds it against the
plain versions and against the JAX package's ``sema_batch_packed`` and
``acquire_hierarchical_packed`` on seeded inputs: B in {1, 8, 31, 32, 33,
4096}, no repeats, one hot slot, every row one tenant, mixed-sign semaphore
rows on one slot, padding and out-of-range slots, a tenant whose admitted
demand passes 2^24, a child table of 2^24 + 12,345 slots, and keys scoped
to their tenants (a large batch spread over blocks by tenant).

Tolerance: none. Semaphore replies and every state field are equal bit for
bit. Two-level grants, replies, ``last_ts`` and ``exists`` are equal bit
for bit, and tokens too: the inputs keep every partial sum exact in float32
(whole costs; past 2^24 multiples of 8 below 2^27), where the kernel's one
subtraction of an int64 sum equals the plain version's subtraction row by
row, and the fill rates are powers of two, so that XLA's fused multiply-add
on the CPU rounds the refill as the port does.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    DeviceBucketStore as JStore,
)
from distributedratelimiting.redis_tpu_torch import (
    DeviceBucketStore,
    ManualClock,
)
from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

EMPTY = 2**32 - 1  # the padding key: no slot is >= 2^31
WARP_ROWS = 32
NOW = 50_000
f32 = np.float32


# -- the decomposition ---------------------------------------------------------

def warp_prefix(keys, demand):
    """The warp path: ``(pre, total, writer)`` — per row the int64 sum of
    ``demand`` over its lower-lane peers and over all its peers, and whether
    it is the highest lane of its peer set. Padding rows get zeros."""
    b = len(keys)
    assert b <= WARP_ROWS
    valid = keys != EMPTY
    peers = (keys[:, None] == keys[None, :]) & valid[:, None]
    lane = np.arange(b)
    d = demand.astype(np.int64)
    pre = (peers & (lane[None, :] < lane[:, None])) @ d
    total = peers @ d
    highest = np.where(peers, lane[None, :], -1).max(axis=1)
    return pre, np.where(valid, total, 0), valid & (highest == lane)


def block_order(keys, rng):
    """The block path's ordering: ``(n_rep, rep, order, head)``.

    ``rep`` is each row's compact id (-1: its slot is alone, or padding),
    ``order`` the rows by sorted position (a stable 4-bit LSD radix sort of
    the ids, lone rows after them), ``head`` the segment heads by sorted
    position."""
    b = len(keys)
    valid = keys != EMPTY
    rep = np.full(b, -1, np.int64)
    uniq, inv = np.unique(keys[valid], return_inverse=True)
    rows = np.nonzero(valid)[0]
    cnt = np.bincount(inv, minlength=len(uniq))
    repeated = np.nonzero(cnt > 1)[0]
    n_rep = len(repeated)
    if n_rep == 0:
        return 0, rep, None, None
    ids = np.full(len(uniq), -1, np.int64)
    ids[repeated] = rng.permutation(n_rep)  # the atomics' order
    rep[rows] = ids[inv]
    key = np.where(rep >= 0, rep, n_rep)
    bits = int(n_rep).bit_length()
    assert bits <= 12 and key.max() < 2**bits  # <= 3 passes of 4 bits
    order = np.arange(b)
    for shift in range(0, bits, 4):
        digit = (key[order] >> shift) & 15
        order = order[np.argsort(digit, kind="stable")]
    ks = key[order]
    head = np.r_[True, ks[1:] != ks[:-1]] | (ks == n_rep)
    return n_rep, rep, order, head


def segmented(order, head, demand):
    """Inclusive int64 segmented sums of ``demand`` in sorted order, by
    row."""
    d = demand.astype(np.int64)[order]
    incl = np.empty_like(d)
    run = 0
    for p in range(len(d)):
        run = d[p] if head[p] else run + d[p]
        incl[p] = run
    out = np.empty_like(incl)
    out[order] = incl
    return out


def block_prefix(keys, demand, rng):
    """The block path's exclusive same-slot prefix of ``demand`` by row, and
    its ordering (:func:`block_order`)."""
    n_rep, rep, order, head = block_order(keys, rng)
    if n_rep == 0:
        return np.zeros(len(keys), np.int64), (n_rep, rep, order, head)
    demand = np.where(rep >= 0, demand, 0)
    return (segmented(order, head, demand) - demand,
            (n_rep, rep, order, head))


def block_totals(keys, order_info, used):
    """The block path's commit: ``(total, writer)`` — per row the int64 sum
    of ``used`` over its slot's rows (a second scan in the level's sorted
    order) and whether it writes the slot (its segment's last row; every
    valid row where no slot repeats)."""
    n_rep, _, order, head = order_info
    valid = keys != EMPTY
    if n_rep == 0:
        return used, valid
    incl = segmented(order, head, used)
    tail = np.zeros(len(keys), bool)
    tail[order] = np.r_[head[1:], True]
    return incl, valid & tail


def block_of(keys, g):
    """The block of G each row goes to on the card: a hash of its slot (all
    rows of a slot meet in one block), a padding row by its index."""
    h = ((keys.astype(np.uint64) * np.uint64(2654435761)) & np.uint64(
        0xFFFFFFFF)) >> np.uint64(7)
    return np.where(keys != EMPTY, (h % np.uint64(g)).astype(np.int64),
                    np.arange(len(keys)) % g)


def spread(b):
    """Blocks a batch of B rows is spread over (1: one block or a warp)."""
    return 1 if b <= 256 else min(64, b // 64)


def partition(keys):
    """The two-level kernel's blocks, by tenant key: each row's
    :func:`block_of` over :func:`spread`, or 0 for every row where every
    valid row goes to row 0's block (row 0 valid): then block 0 decides the
    batch alone."""
    part = block_of(keys, spread(len(keys)))
    valid = keys != EMPTY
    if valid[0] and (part[valid] == part[0]).all():
        part[:] = 0
    return part


def emulate_sema(state, packed, rng):
    """``sema_packed``'s decomposition, IN PLACE on ``state`` (numpy
    arrays active, last_ts, exists): each block decides its share of the
    slots as one batch in request order. Returns ``out f32[2, B]``."""
    slots = packed[0]
    n = len(state[0])
    valid = (slots >= 0) & (slots < n)
    keys = np.where(valid, slots.astype(np.int64), EMPTY)
    out = np.zeros((2, len(slots)), f32)
    part = block_of(keys, spread(len(slots)))
    for g in np.unique(part):
        rows = np.nonzero(part == g)[0]  # in request order
        out[:, rows] = _sema_block(state, packed[:, rows], keys[rows],
                                   len(slots) <= WARP_ROWS, rng)
    return out


def _sema_block(state, packed, keys, warp, rng):
    """One block's (or the warp's) rows, as one batch."""
    active, last_ts, exists = state
    slots, deltas, limits, now = packed[0], packed[1], packed[2], packed[3, 0]
    b = len(slots)
    valid = keys != EMPTY
    gs = np.where(valid, slots, 0)
    old = np.where(valid & exists[gs], active[gs], 0).astype(np.int64)
    acq = np.where(valid, np.maximum(deltas, 0), 0)

    def decide(pre):
        fits = ((old.astype(f32) + pre.astype(f32)) + acq.astype(f32)
                <= limits.astype(f32))
        return valid & ((deltas < 0) | fits)

    if warp:
        pre, _, _ = warp_prefix(keys, acq)
        ok = decide(pre)
        applied = np.where(ok, deltas, 0)
        apre, total, writer = warp_prefix(keys, applied)
    else:
        pre, order_info = block_prefix(keys, acq, rng)
        ok = decide(pre)
        applied = np.where(ok, deltas, 0)
        # The second scan; each segment's last row writes.
        total, writer = block_totals(keys, order_info, applied)
        apre = total - applied if order_info[0] else np.zeros(b, np.int64)
    after = np.maximum((old.astype(f32) + apre.astype(f32))
                       + applied.astype(f32), f32(0))
    w = slots[writer]
    active[w] = np.maximum(old[writer] + total[writer], 0)
    touch = slots[valid & (deltas != 0)]
    last_ts[touch] = now
    exists[touch] = True
    return np.stack([ok.astype(f32), np.where(valid, after, f32(0))])


def _refill(state, slots, valid, now, cap, rate):
    gs = torch.from_numpy(np.where(valid, slots, 0).astype(np.int64))
    return bm.refill_or_init(*(torch.from_numpy(a)[gs] for a in state),
                             int(now), cap, rate).numpy()


def emulate_hier(child, parent, packed, ccap, crate, pcap, prate, rng):
    """``acquire_hierarchical``'s decomposition, IN PLACE on ``child`` and
    ``parent`` (numpy arrays tokens, last_ts, exists): each block decides
    its share of the tenants as one batch in request order; where a key's
    rows fall under two blocks, one block decides them all. Returns ``out
    f32[2, B]``."""
    cs, ps = packed[0], packed[3]
    b = len(cs)
    valid = ((cs >= 0) & (cs < len(child[0])) & (ps >= 0)
             & (ps < len(parent[0])))
    ckeys = np.where(valid, cs.astype(np.int64), EMPTY)
    pkeys = np.where(valid, ps.astype(np.int64), EMPTY)
    part = partition(pkeys)
    for k in np.unique(ckeys[valid]):  # a key under two blocks: one block
        if len(np.unique(part[ckeys == k])) > 1:
            part[:] = 0
            break
    out = np.zeros((2, b), f32)
    for g in np.unique(part):
        rows = np.nonzero(part == g)[0]  # in request order
        out[:, rows] = _hier_block(
            child, parent, packed[:, rows], valid[rows], ckeys[rows],
            pkeys[rows], (ccap, crate, pcap, prate), b <= WARP_ROWS, rng)
    return out


def _hier_block(child, parent, packed, valid, ckeys, pkeys, args, warp,
                rng):
    """One block's (or the warp's) rows, as one batch."""
    ccap, crate, pcap, prate = args
    cs, cnt, now, ps = packed[0], packed[1], packed[2, 0], packed[3]
    c_ref = _refill(child, cs, valid, now, ccap, crate)
    p_ref = _refill(parent, ps, valid, now, pcap, prate)
    c = cnt.astype(f32)
    dem = np.where(valid, cnt, 0)
    if warp:
        c_pre = warp_prefix(ckeys, dem)[0]
    else:
        c_pre, c_ord = block_prefix(ckeys, dem, rng)
    child_ok = valid & (c_ref >= c_pre.astype(f32) + c)
    dem = np.where(child_ok, cnt, 0)
    if warp:
        p_pre = warp_prefix(pkeys, dem)[0]
    else:
        p_pre, p_ord = block_prefix(pkeys, dem, rng)
    granted = child_ok & (p_ref >= p_pre.astype(f32) + c)
    used = np.where(granted, cnt, 0).astype(np.int64)
    cons = np.where(granted, c, f32(0))
    rem = np.minimum(
        np.maximum((c_ref - c_pre.astype(f32)) - cons, f32(0)),
        np.maximum((p_ref - p_pre.astype(f32)) - cons, f32(0)))
    # One writer a slot: the refilled balance less the int64 sum of the
    # slot's consumption, subtracted once.
    for table, keys, ref, order in ((child, ckeys, c_ref, None if warp
                                     else c_ord),
                                    (parent, pkeys, p_ref, None if warp
                                     else p_ord)):
        if warp:
            _, total, writer = warp_prefix(keys, used)
        else:
            total, writer = block_totals(keys, order, used)
        s = keys[writer]
        table[0][s] = ref[writer] - total[writer].astype(f32)
        table[1][s] = now
        table[2][s] = True
    return np.stack([granted.astype(f32), np.where(valid, rem, f32(0))])


# -- seeded cases -----------------------------------------------------------------

SEMA_CASES = [("mixed", 1), ("mixed", 8), ("mixed", 31), ("mixed", 32),
              ("mixed", 33), ("mixed", 4096), ("distinct", 8),
              ("distinct", 33), ("distinct", 4096), ("hot", 32),
              ("hot", 4096), ("mixed_sign", 8), ("mixed_sign", 64),
              ("padding", 32), ("padding", 4096)]
HIER_CASES = [("mixed", 1), ("mixed", 8), ("mixed", 31), ("mixed", 32),
              ("mixed", 33), ("mixed", 4096), ("distinct", 8),
              ("distinct", 33), ("distinct", 4096), ("hot", 32),
              ("hot", 4096), ("one_tenant", 32), ("one_tenant", 4096),
              ("padding", 32), ("padding", 4096), ("past_2_24", 32),
              ("past_2_24", 4096), ("grown", 32), ("grown", 4096),
              ("scoped", 1000), ("scoped", 4096)]


def _seed(case, b):
    return [b, len(case), sum(map(ord, case))]


def _sema_case(case, b, rng):
    """``(state arrays, packed i32[4, B])`` on a table of 2^14 slots."""
    n = 2**14
    state = (rng.integers(0, 6, n).astype(np.int32),
             rng.integers(NOW - 3000, NOW + 50, n).astype(np.int32),
             rng.random(n) < 0.6)
    if case == "distinct":
        slots = rng.choice(n, b, replace=False)
    elif case == "hot":
        slots = np.full(b, 77)
    elif case == "mixed_sign":  # acquires, releases and probes of one slot
        slots = np.full(b, 5)
        slots[b // 2:] = rng.integers(0, 3, b - b // 2)
    else:
        slots = np.minimum(rng.zipf(1.3, b) - 1, n - 1)
    slots = slots.astype(np.int32)
    if case in ("mixed", "padding"):
        share = 0.3 if case == "padding" else 0.05
        slots[rng.random(b) < share] = -1
        slots[rng.random(b) < share / 2] = n + 3
        slots[rng.random(b) < share / 4] = -2**31
    deltas = rng.integers(-2, 4, b).astype(np.int32)
    limits = rng.integers(0, 12, b).astype(np.int32)
    if case in ("distinct", "hot"):  # acquires and probes
        deltas = rng.integers(0, 4, b).astype(np.int32)
    if case == "hot":
        limits[:] = 30
    elif case == "mixed_sign":
        limits = rng.integers(6, 12, b).astype(np.int32)
    return state, np.stack([slots, deltas, limits,
                            np.full(b, NOW, np.int32)])


def _hier_case(case, b, rng):
    """``(child arrays, parent arrays, packed i32[4, B], (ccap, crate, pcap,
    prate))``. Fill rates are powers of two (exact refills)."""
    nc, np_ = 2**14, 256
    ccap, pcap, crate, prate = 16.0, 60.0, 2.0**-10, 2.0**-8
    cost_hi = 12
    if case == "grown":
        nc = 2**24 + 12_345
    if case == "past_2_24":
        ccap, pcap, crate, prate = 2.0**26, 2.0**26, 8.0, 8.0
    cs = np.minimum(rng.zipf(1.5, b) - 1, 3000)
    ps = rng.zipf(1.2, b) % 64
    if case == "distinct":
        cs = rng.choice(nc, b, replace=False)
        ps = rng.choice(np_, min(b, np_), replace=False)[np.arange(b)
                                                         % min(b, np_)]
    elif case == "hot":
        cs, ps = np.full(b, 9), np.full(b, 3)
    elif case == "one_tenant":
        cs, ps = rng.choice(nc, b, replace=False), np.zeros(b)
    elif case == "past_2_24":
        cs, ps = rng.integers(0, 8, b), np.where(rng.random(b) < 0.8, 1, 2)
    elif case == "scoped":  # each key under one tenant: spread by tenant
        ps = rng.zipf(1.2, b) % 64
        cs = ps * 64 + rng.zipf(1.5, b) % 64
    elif case == "grown":
        cs = nc - 1 - rng.integers(0, 40, b)
        cs[::3] = rng.integers(0, 2**24, len(cs[::3]))
    cs, ps = cs.astype(np.int32), ps.astype(np.int32)
    if case in ("mixed", "padding"):
        share = 0.3 if case == "padding" else 0.05
        cs[rng.random(b) < share] = -1
        ps[rng.random(b) < share / 2] = np_ + 9
        cs[rng.random(b) < share / 4] = nc
    costs = rng.integers(0, cost_hi, b)
    if case == "past_2_24":  # multiples of 8: partial sums exact < 2^27
        costs = 2**21 + 8 * rng.integers(0, 2**15, b)
    costs = costs.astype(np.int32)

    def bucket(n, cap):
        top = cap if case != "past_2_24" else 2.0**25
        tokens = rng.uniform(0, top, n).astype(np.float32)
        if case == "past_2_24":
            tokens = (8 * np.floor(tokens / 8)).astype(np.float32)
        return (tokens,
                rng.integers(NOW - 3000, NOW + 50, n).astype(np.int32),
                rng.random(n) < 0.6)

    child, parent = bucket(nc, ccap), bucket(np_, pcap)
    if case == "past_2_24":  # tenants 1 and 2 start full: 2^26 tokens
        parent[2][1:3] = False
    elif case == "hot":  # both hot slots start full
        child[2][9] = parent[2][3] = False
    return (child, parent,
            np.stack([cs, costs, np.full(b, NOW, np.int32), ps]),
            (ccap, crate, pcap, prate))


def _copy(arrays):
    return tuple(a.copy() for a in arrays)


@pytest.mark.parametrize("case,b", SEMA_CASES)
def test_sema_decomposition_matches_plain_and_jax(case, b):
    rng = np.random.default_rng(_seed(case, b))
    state, packed = _sema_case(case, b, rng)
    ours = _copy(state)
    got = emulate_sema(ours, packed, rng)
    plain = K.SemaState(*(torch.from_numpy(a.copy()) for a in state))
    _, want = K.sema_batch_packed(plain, torch.from_numpy(packed))
    jstate, jout = JK.sema_batch_packed(
        JK.SemaState(*(jnp.asarray(a) for a in state)), jnp.asarray(packed))
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, np.asarray(jout))
    for name, g, p, j in zip(plain._fields, ours, plain, jstate):
        np.testing.assert_array_equal(g, p.numpy(), err_msg=name)
        np.testing.assert_array_equal(g, np.asarray(j), err_msg=name)
    acquires = (packed[0] >= 0) & (packed[0] < len(state[0])) & (
        packed[1] > 0)
    if b >= 32:  # a mix of grants and denials
        assert 0 < got[0][acquires].sum() < acquires.sum()


@pytest.mark.parametrize("case,b", HIER_CASES)
def test_hier_decomposition_matches_plain_and_jax(case, b):
    rng = np.random.default_rng(_seed(case, b))
    child, parent, packed, args = _hier_case(case, b, rng)
    oc, op = _copy(child), _copy(parent)
    got = emulate_hier(oc, op, packed, *args, rng)
    pc, pp = (K.BucketState(*(torch.from_numpy(a.copy()) for a in t))
              for t in (child, parent))
    _, _, want = K.acquire_hierarchical_packed(
        pc, pp, torch.from_numpy(packed), *args)
    jc, jp, jout = JK.acquire_hierarchical_packed(
        JK.BucketState(*(jnp.asarray(a) for a in child)),
        JK.BucketState(*(jnp.asarray(a) for a in parent)),
        jnp.asarray(packed), *(jnp.float32(a) for a in args))
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, np.asarray(jout))
    for ours, plain, jax_ in ((oc, pc, jc), (op, pp, jp)):
        for name, g, p, j in zip(plain._fields, ours, plain, jax_):
            np.testing.assert_array_equal(g, p.numpy(), err_msg=name)
            np.testing.assert_array_equal(g, np.asarray(j), err_msg=name)
    valid = ((packed[0] >= 0) & (packed[0] < len(child[0]))
             & (packed[3] >= 0) & (packed[3] < len(parent[0])))
    if b > 8:  # a mix of grants and denials
        assert 0 < got[0][valid].sum() < valid.sum()
    if case == "past_2_24":  # the tenant's admitted demand passes 2^24
        t1 = valid & (packed[3] == 1) & (got[0] > 0.5)
        if b > WARP_ROWS:
            assert packed[1][t1].astype(np.int64).sum() > 2**24


def test_compact_ids_take_few_radix_passes():
    """The LLM workload's tenants (64, Zipf(1.2)) in a 4096-row batch sort
    by at most 7 bits (two passes of 4 bits), where a sort by the 2^18-slot
    tenant table's slot takes 19 bits (five passes); a batch of distinct
    slots sorts not at all."""
    rng = np.random.default_rng(3)
    tenants = (rng.zipf(1.2, 4096) % 64).astype(np.int64) * 4099 % 2**18
    n_rep, _, order, _ = block_order(tenants, rng)
    assert 0 < n_rep <= 64 and int(n_rep).bit_length() <= 7
    assert order is not None
    distinct = rng.choice(2**18, 4096, replace=False).astype(np.int64)
    assert block_order(distinct, rng)[0] == 0



@pytest.mark.parametrize("case", ["one_tenant", "small_frame",
                                  "padded_frame", "distinct",
                                  "row0_padding"])
def test_one_tenant_takes_one_block(case):
    """A two-level batch whose valid rows all go to row 0's block (one
    tenant's 4096 rows; a 300-row frame padded to 512; 1500 rows padded to
    4096) is decided by one block; a batch of distinct tenants spreads over
    every block; where row 0 is padding the batch is partitioned even if one
    tenant holds every other row."""
    rng = np.random.default_rng(5)
    b = 512 if case == "small_frame" else 4096
    rows = np.arange(b)
    keys = {"one_tenant": np.full(b, 4099, np.int64),
            "small_frame": np.where(rows < 300, 77, EMPTY),
            "padded_frame": np.where(rows < 1500, 4099, EMPTY),
            "distinct": rng.choice(2**18, b, replace=False).astype(np.int64),
            "row0_padding": np.where(rows == 0, EMPTY, 77)}[case]
    blocks = len(np.unique(partition(keys)))
    if case == "distinct":
        assert blocks == spread(b) == 64
    elif case == "row0_padding":  # row 0 in block 0, the tenant's in its own
        assert blocks == 1 + (block_of(keys, 64)[1] != 0)
    else:
        assert blocks == 1


# -- the store's padding ------------------------------------------------------------

async def _hier_rows(store):
    rng = np.random.default_rng(21)
    cfg = (60.0, 4.0, 12.0, 2.0)  # tenant (cap, rate), key (cap, rate)
    out = []
    rows = []
    res = await store.acquire_hierarchical("t0", "solo", 7, *cfg)
    out.append((res.granted, res.remaining))
    rows.append(store.metrics.rows_processed)
    tenants = [f"t{t % 3}" for t in rng.zipf(1.3, 33)]
    keys = [f"k{int(k) % 9}" for k in rng.zipf(1.5, 33)]
    costs = rng.integers(1, 9, 33)
    r = await store.acquire_hierarchical_many(tenants, keys, costs, *cfg)
    out.append((r.granted.tolist(), r.remaining.tolist()))
    rows.append(store.metrics.rows_processed)
    return out, rows


def test_store_pads_hierarchical_chunks_to_their_rows():
    """A one-row request launches 8 rows and a 33-row chunk 64 (the JAX
    store pads both to ``max_batch``); grants and remaining equal the JAX
    store's."""
    port = DeviceBucketStore(device="cpu", clock=ManualClock(10_000),
                             n_slots=64, max_batch=4096)
    jax_ = JStore(clock=JClock(10_000), n_slots=64, max_batch=4096)
    got, rows = asyncio.run(_hier_rows(port))
    want, _ = asyncio.run(_hier_rows(jax_))
    assert got == want
    assert rows == [8, 8 + 64]
    assert 0 < sum(got[1][0]) < 33  # both outcomes in the chunk
