"""``sweep_counters``'s contract, on the CPU: the port against JAX.

The card's kernel (``csrc/counter.cu``, ``sweep_counters_kernel``) gives
each tile of 32,768 slots to a thread block cluster of 8 blocks x 256
threads, 16 slots a thread: one 16-byte word of ``exists`` (four 32-bit
words of four slot bytes, little-endian), four 16-byte loads of
``last_ts``, one 16-byte store of the mask, ``exists`` written back only
where a slot expired; a thread whose 16 slots run past N, or a table whose
pointers are not 16-byte aligned, takes a scalar path over the same slots.
Each cluster's leader stores its tile's count with a plain store.

This file holds the port's plain version (``ck.sweep_counters`` on a CPU
table) and a numpy transliteration of that decomposition (both paths)
against JAX's ``kernels.sweep_counters`` at N in {1, 15, 16, 17, 4101,
32768, 2^16 + 3} (a tail shorter than a thread's 16 slots, one thread
exactly, a table smaller than a tile, one whole tile, a last partial tile),
``last_ts`` spread over two days either side of the 86400 s TTL, half the
counters live. The mask and ``exists`` are equal bit for bit, and
``tile_counts`` equals the mask's sum over each tile of 32,768 slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

TTL = 86400 * 1024
NOW = 200_000_000
SIZES = (1, 15, 16, 17, 4101, 32768, 2**16 + 3)
THREADS, SLOTS, BLOCKS = 256, 16, 8  # a block, a thread, a cluster


def _table(n):
    rng = np.random.default_rng(n)
    last_ts = rng.integers(NOW - 2 * TTL, NOW + 300, n).astype(np.int32)
    exists = rng.random(n) < 0.5
    if n >= 16:  # one thread's word with every slot live and expired
        last_ts[:16], exists[:16] = NOW - TTL, True
    return last_ts, exists


def _expired(ex, last):
    """The kernel's rule: live, and max(0, now - last) (int32 wrap) >= TTL."""
    elapsed = np.maximum((np.int64(NOW) - last.astype(np.int64)
                          + 2**31) % 2**32 - 2**31, 0)
    return (ex != 0) & (elapsed >= TTL)


def emulate_sweep(last_ts, exists, vec):
    """``sweep_counters_kernel``'s indexing and its two paths, in numpy, on
    copies; returns ``(mask, exists, tile_counts)``."""
    n = len(last_ts)
    ex_bytes = exists.astype(np.uint8)
    mask = np.full(n, 0x55, np.int8)  # what the kernel must overwrite
    tiles = -(-n // ck.TILE)
    counts = np.full(tiles, -7, np.int32)  # no zeroing
    for tile in range(tiles):
        block_sums = []
        for rank in range(BLOCKS):
            total = 0
            for t in range(THREADS):
                base = tile * ck.TILE + (rank * THREADS + t) * SLOTS
                if vec and base + SLOTS <= n:
                    words = ex_bytes[base:base + SLOTS].view("<u4")
                    ts = last_ts[base:base + SLOTS]
                    out = np.zeros(4, "<u4")
                    keep = words.copy()
                    for q in range(4):
                        for j in range(4):
                            byte = (int(words[q]) >> (8 * j)) & 0xFF
                            if _expired(np.uint8(byte), ts[4 * q + j]):
                                out[q] |= 1 << (8 * j)
                                keep[q] &= ~np.uint32(0xFF << (8 * j))
                        total += bin(int(out[q])).count("1")
                    mask[base:base + SLOTS] = out.view(np.int8)
                    if out.any():
                        ex_bytes[base:base + SLOTS] = keep.view(np.uint8)
                else:
                    for i in range(base, min(base + SLOTS, n)):
                        e = bool(_expired(ex_bytes[i], last_ts[i]))
                        if e:
                            ex_bytes[i] = 0
                        mask[i] = e
                        total += e
            block_sums.append(total)  # its warps', then its own
        counts[tile] = sum(block_sums)  # the leader's, from the blocks'
    return mask, ex_bytes.astype(bool), counts


@pytest.mark.parametrize("n", SIZES)
def test_sweep_counters_contract_matches_jax(n):
    last_ts, exists = _table(n)
    zeros = np.zeros(n, np.float32)
    jstate, jfreed = JK.sweep_counters(
        JK.CounterState(jnp.asarray(zeros), jnp.asarray(zeros),
                        jnp.asarray(last_ts), jnp.asarray(exists)),
        jnp.int32(NOW))
    want = np.asarray(jfreed)
    want_exists = np.asarray(jstate.exists)
    want_tiles = np.zeros(-(-n // ck.TILE) * ck.TILE, np.int32)
    want_tiles[:n] = want
    want_tiles = want_tiles.reshape(-1, ck.TILE).sum(1)
    assert 0 < want.sum() < exists.sum() or n < 32  # a mix past one word

    state = K.CounterState(*(torch.tensor(a) for a in
                             (zeros, zeros, last_ts, exists)))
    mask, counts = ck.sweep_counters(state, NOW)
    np.testing.assert_array_equal(mask.numpy(), want.astype(np.int8))
    np.testing.assert_array_equal(state.exists.numpy(), want_exists)
    np.testing.assert_array_equal(counts.numpy(), want_tiles)

    for vec in (True, False):
        got_mask, got_exists, got_tiles = emulate_sweep(last_ts, exists, vec)
        np.testing.assert_array_equal(got_mask, want.astype(np.int8))
        np.testing.assert_array_equal(got_exists, want_exists)
        np.testing.assert_array_equal(got_tiles, want_tiles)
