"""The bulk-lane scan's slot-major decomposition, on the CPU.

The card's scan kernel (``csrc/decide.cuh``) does not decide a chunk of K
batches batch by batch, as the plain version (``K.acquire_scan_packed``,
``K.window_acquire_scan``: JAX's ``lax.scan`` as a loop) does. It orders the
chunk's rows by slot once, stably, so that each slot's rows stand in
``(k, row)`` order; gathers each slot once; walks the slot's batch groups in
order (advance to the batch's tick, decide every row of the group from that
state with its int64 same-batch prefix, sum the granted counts in int64,
carry the state that a commit would store); and commits each slot once.

This file emulates that decomposition in numpy and torch — it lives here, not
in the package — and holds it against the per-batch plain loop on seeded
inputs that stress it: slots repeating across batches with ticks of their own
(one going back), one hot slot taking every row, i32 counts whose per-slot
demand passes 2^24, padding and out-of-range slots, a table of 2^24 + 12,345
slots, zero counts; for token buckets and sliding and fixed windows.

Every result and every state field is held equal bit for bit. Past 2^24
the counts are multiples of 8 and a slot's state stays below 2^27, so every
partial sum of granted counts is exact in float32 and the plain version's
row-by-row float adds equal the kernel's int64 sum applied once; the
prefixes pass 2^27, where only their int64 sum, converted once, matches.
"""

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import kernels as K

CAP, RATE = 10.0, 0.013
W_LIMIT, W_TICKS = 20.0, 1000


def slot_major_scan(kind, state, slots_k, counts_k, nows_k, cap_or_limit,
                    rate_or_window):
    """The kernel's decomposition of one chunk, IN PLACE on ``state``.

    ``kind`` is "bucket", "sliding" or "fixed"; ``slots_k``/``counts_k``
    int numpy ``[K, B]``, ``nows_k`` int32 numpy ``[K]``. Returns
    ``(granted bool[K, B], remaining f32[K, B])``. Each step advances, for
    every slot at once, the slot's next batch group: the serial depth is per
    slot, at most K."""
    k_, b_ = slots_k.shape
    n = state[0].shape[0]
    s = slots_k.reshape(-1).astype(np.int64)
    c = counts_k.reshape(-1).astype(np.int64)
    valid = (s >= 0) & (s < n)
    rows = np.nonzero(valid)[0]
    # 1. One stable order by slot: each slot's rows in (k, row) order.
    order = rows[np.argsort(s[rows], kind="stable")]
    ss, kk, cc = s[order], order // b_, c[order]
    m = len(order)
    new_slot = np.r_[True, ss[1:] != ss[:-1]] if m else np.zeros(0, bool)
    new_group = (new_slot | np.r_[True, kk[1:] != kk[:-1]] if m
                 else np.zeros(0, bool))
    slot_id = np.cumsum(new_slot) - 1
    group_id = np.cumsum(new_group) - 1
    g_first = np.nonzero(new_group)[0]
    g_slot = slot_id[g_first]
    g_k = kk[g_first]
    # The group's ordinal within its slot: the walk's step.
    s_first_group = np.r_[0, np.cumsum(np.bincount(g_slot))[:-1]] if m else []
    g_step = np.arange(len(g_first)) - np.asarray(s_first_group)[g_slot]
    # Exclusive int64 prefix of earlier demand in the same batch group.
    csum = np.cumsum(cc)
    pre = csum - cc - (csum - cc)[g_first][group_id] if m else cc
    uniq = torch.from_numpy(ss[new_slot])
    # 2. One gather per distinct slot.
    old = [t[uniq].clone() for t in state]
    granted = np.zeros(k_ * b_, bool)
    remaining = np.zeros(k_ * b_, np.float32)
    pre_f = torch.from_numpy(pre).to(torch.float32)
    c_f = torch.from_numpy(cc).to(torch.float32)
    # 3. The walk: step j advances every slot's j-th group.
    for step in range(int(g_step.max()) + 1 if m else 0):
        gs = np.nonzero(g_step == step)[0]
        si = torch.from_numpy(g_slot[gs])
        now = torch.from_numpy(nows_k[g_k[gs]].astype(np.int32))
        rsel = np.nonzero(np.isin(group_id, gs))[0]
        gi = torch.from_numpy(np.searchsorted(gs, group_id[rsel]))
        if kind == "bucket":
            adv = bm.refill_or_init(old[0][si], old[1][si], old[2][si], now,
                                    cap_or_limit, rate_or_window)
            room = adv[gi]
            ok = room >= pre_f[rsel] + c_f[rsel]
        else:
            prev, curr, idx = bm.sliding_window_advance(
                old[0][si], old[1][si], old[2][si], old[3][si], now,
                rate_or_window)
            est = (bm.sliding_window_estimate(prev, curr, idx, now,
                                              rate_or_window)
                   if kind == "sliding" else curr)
            lim = torch.tensor(cap_or_limit, dtype=torch.float32)
            room = lim - est[gi]
            ok = est[gi] + pre_f[rsel] + c_f[rsel] <= lim
        used = torch.where(ok, c_f[rsel], torch.zeros_like(c_f[rsel]))
        granted[order[rsel]] = ok.numpy()
        remaining[order[rsel]] = torch.clamp_min(
            room - pre_f[rsel] - used, 0.0).numpy()
        # The group's granted demand, summed in int64 ...
        cons = torch.zeros(len(gs), dtype=torch.int64)
        cons.index_add_(0, gi, torch.where(ok, torch.from_numpy(cc[rsel]),
                                           torch.zeros((), dtype=torch.int64)))
        # ... applied once: the carried state, which the next group reads
        # and the slot's last group commits.
        if kind == "bucket":
            old[0][si] = adv - cons.to(torch.float32)
            old[1][si] = now
            old[2][si] = True
        else:
            old[0][si] = prev
            old[1][si] = curr + cons.to(torch.float32)
            old[2][si] = idx
            old[3][si] = True
    # 4. One commit per distinct slot.
    for t, o in zip(state, old):
        t[uniq.long()] = o
    return granted.reshape(k_, b_), remaining.reshape(k_, b_)


def _case(case, rng):
    """``(n, slots [K, B], counts [K, B], nows [K], i32 counts?)``."""
    n, k, b = 257, 6, 64
    nows = 50_000 + 300 * (3 * np.arange(k) // k)
    big = False
    if case == "cross":
        base = rng.permutation(n)[:b]
        slots = np.stack([rng.permutation(base) for _ in range(k)])
        slots[:, :8] = base[:8]  # and repeats within each batch
        nows = 50_000 + 97 * np.arange(k)
        nows[3] = nows[2] - 300  # the clock goes back
    elif case == "hot":
        slots = np.full((k, b), 11)
    elif case == "past_2_24":
        slots = np.stack([rng.permutation(np.arange(b) % 2)
                          for _ in range(k)])
        big = True
    elif case == "padding":
        slots = rng.integers(0, n, (k, b))
        slots[rng.random((k, b)) < 0.3] = -1
        slots[rng.random((k, b)) < 0.1] = n + 5
        slots[rng.random((k, b)) < 0.05] = -2**31
    elif case == "grown":
        n = 2**24 + 12_345
        slots = n - 1 - rng.integers(0, 40, (k, b))
        slots[:, ::3] = rng.integers(0, 2**24, (k, (b + 2) // 3))
    else:  # zero counts: probes, alone and beside demand
        slots = rng.integers(0, 20, (k, b))
    if big:
        counts = 2**23 + 8 * rng.integers(0, 5, (k, b))
    else:
        counts = rng.integers(0, 8, (k, b))
    if case == "zero":
        counts[:, ::2] = 0
        counts[-1] = 0
    return (n, slots.astype(np.int32), counts.astype(np.int32),
            nows.astype(np.int32), big)


def _state(kind, n, rng, big):
    if kind == "bucket":
        cap = float(2**26) if big else CAP
        return K.BucketState(
            torch.from_numpy(rng.uniform(0, cap, n).astype(np.float32)),
            torch.from_numpy(rng.integers(48_000, 50_050, n).astype(
                np.int32)),
            torch.from_numpy(rng.random(n) < 0.6)), cap, RATE
    idx = 50_000 // W_TICKS + rng.choice([-2, -1, 0, 0, 1], n)
    top = float(2**23) if big else 9.0
    return K.WindowState(
        torch.from_numpy(rng.integers(0, top, n).astype(np.float32)),
        torch.from_numpy(rng.integers(0, top, n).astype(np.float32)),
        torch.from_numpy(idx.astype(np.int32)),
        torch.from_numpy(rng.random(n) < 0.6)), \
        (float(2**26) if big else W_LIMIT), W_TICKS


@pytest.mark.parametrize("kind", ["bucket", "sliding", "fixed"])
@pytest.mark.parametrize("case", ["cross", "hot", "past_2_24", "padding",
                                  "grown", "zero"])
def test_slot_major_decomposition_equals_per_batch_loop(kind, case):
    rng = np.random.default_rng([len(kind), len(case), ord(case[0])])
    n, slots, counts, nows, big = _case(case, rng)
    if big:  # the prefixes pass 2^27: only an int64 sum gets them right
        assert int(counts[0][slots[0] == slots[0][0]].sum()) > 2**27
    state, a, b = _state(kind, n, rng, big)
    plain = type(state)(*(t.clone() for t in state))
    ours = type(state)(*(t.clone() for t in state))
    slots_t, counts_t = torch.from_numpy(slots), torch.from_numpy(counts)
    nows_t = torch.from_numpy(nows)
    if kind == "bucket":
        _, out = K.acquire_scan_packed(plain, slots_t, counts_t, nows_t, a, b)
        want_g, want_r = out[:, 0] > 0.5, out[:, 1]
    else:
        _, want_g, want_r = K.window_acquire_scan(
            plain, slots_t, counts_t, slots_t >= 0, nows_t, a, b,
            interpolate=kind == "sliding")
    got_g, got_r = slot_major_scan(kind, ours, slots, counts, nows, a, b)
    np.testing.assert_array_equal(got_g, want_g.numpy())
    np.testing.assert_array_equal(got_r, want_r.numpy())
    for name, got, want in zip(state._fields, ours, plain):
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=name)
    # The case decided something and denied something (a zero-count chunk
    # grants every probe).
    assert got_g.any()
    if case != "zero":
        assert not got_g[(slots >= 0) & (slots < n)].all()
