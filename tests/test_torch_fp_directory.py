"""The port's fingerprint directory (``ops/fp_directory.py``) against the JAX
package's, on the CPU: the host hash, the placement, and every function of
the module on the same inputs, made from numpy seeds.

Tolerance: 0 — fingerprints, bases and preferences bit-equal; tables (the
fp cells included), slots, grants, resolve flags, bit planes and peeks
equal; bucket remaining and tokens equal; a debit's replies equal on whole
amounts. Windows: grants, indices and counts equal, remaining within 1.5
float32 ulps of the limit (XLA on the CPU contracts the sliding estimate's
``curr + prev * (1 - frac)`` into a fused multiply-add, the port never
does). The plain resolve keeps a contested cell's LAST claimant row, as
XLA's CPU scatter does, so the plain versions agree with JAX slot for slot,
under window pressure too. The card's kernels agree with the plain
versions by key (``tests/test_torch_fp_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.ops import fp_directory as JF
from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu.runtime import fp_store as jfs
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.runtime import fp_store as pfs
from distributedratelimiting.redis_tpu_torch.runtime.fp_store import (
    fingerprints,
)
from distributedratelimiting.redis_tpu_torch.runtime.wire import KeyBlob

CAP = 5.0
RATE = 1.0 / 1024.0
LIMIT = 6.0
WINDOW = 1024
NOW = 40_000


def _keys(rng, n):
    """Keys of every kind: ASCII, non-ASCII, long, empty, and lone
    surrogates (surrogate-escaped bytes) — the native hash refuses the last
    and the Python one must take them."""
    out = []
    for i in range(n):
        kind = i % 5
        if kind == 0:
            out.append(f"user:{rng.integers(1 << 40)}")
        elif kind == 1:
            out.append(f"ключ-{i}-🔑")
        elif kind == 2:
            out.append("x" * int(rng.integers(0, 300)))
        elif kind == 3:
            out.append(bytes(rng.integers(0, 256, 12, dtype=np.uint8)).decode(
                "utf-8", "surrogateescape"))
        else:
            out.append(str(i))
    return out


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


def _fps(rng, m):
    return rng.integers(1, 2**32, (m, 2), dtype=np.uint64).astype(np.uint32)


# -- the host hash and the placement ------------------------------------------

def test_fingerprints_bit_equal_to_jax_for_100k_keys():
    rng = np.random.default_rng(0)
    keys = _keys(rng, 100_000)
    got = fingerprints(keys)
    np.testing.assert_array_equal(got, jfs.fingerprints(keys))
    assert ((got != 0).any(1)).all()
    # Every lane: the KeyBlob's bytes, the Python FNV.
    enc = [k.encode("utf-8", "surrogateescape") for k in keys[:5000]]
    offsets = np.cumsum([0] + [len(e) for e in enc])
    np.testing.assert_array_equal(
        fingerprints(KeyBlob(b"".join(enc), offsets)), got[:5000])
    for i in range(0, 5000, 97):
        h = pfs._fp64_py(keys[i])
        assert (got[i, 0], got[i, 1]) == (h & 0xFFFFFFFF, h >> 32)
        assert h == jfs._fp64_py(keys[i])


def test_native_and_python_agree():
    """The JAX package's case: the pure-Python FNV equals the native pass
    bit for bit (fingerprints persist in tables and checkpoints)."""
    keys = ["a", "user:42", "ключ-🔑", "", "x" * 300]
    got = fingerprints(keys)
    for i, k in enumerate(keys):
        h = pfs._fp64_py(k)
        assert (got[i, 0], got[i, 1]) == (h & 0xFFFFFFFF, h >> 32)


def test_never_empty_sentinel():
    fps = fingerprints([f"k{i}" for i in range(1000)])
    assert ((fps != 0).any(axis=1)).all()
    assert pfs._fp64_py("") != 0


def test_fingerprints_take_the_native_hash():
    """The native library is built and its list lane is bound: plain str
    keys never fall back to the Python FNV."""
    from distributedratelimiting.redis_tpu_torch.utils.native import (
        load_directory_lib,
    )

    lib = load_directory_lib()
    assert lib is not None and lib.has_pylist
    calls = []
    orig = pfs._fp64_py
    pfs._fp64_py = lambda k: calls.append(k) or orig(k)
    try:
        fingerprints([f"k{i}" for i in range(100)])
    finally:
        pfs._fp64_py = orig
    assert calls == []


@pytest.mark.parametrize("n,lw", [
    (n, lw) for n in (16, 17, 64, 4096, 2**24, 2**31 - 1)
    for lw in (1, 4, 16, 32) if lw <= n])
def test_base_and_pref_bit_equal_to_jax(n, lw):
    rng = np.random.default_rng(n + lw)
    fps = _fps(rng, 100_000)
    fps[:3] = [[0xFFFFFFFF, 0xFFFFFFFF], [1, 0], [0, 1]]
    want = np.asarray(JF._base_index(jnp.asarray(fps), n, lw))
    np.testing.assert_array_equal(F.base_index_np(fps, n, lw), want)
    np.testing.assert_array_equal(
        F._base_index(_t(fps.view(np.int32)), n, lw).numpy(), want)
    kp = jnp.asarray(fps)
    pref = np.asarray(((kp[:, 0] ^ (kp[:, 1] * np.uint32(0x85EBCA6B)))
                       % jnp.uint32(lw)).astype(jnp.int32))
    np.testing.assert_array_equal(F.pref_index_np(fps, lw), pref)
    np.testing.assert_array_equal(
        F._pref_index(_t(fps.view(np.int32)), lw).numpy(), pref)


def test_pack_fp12_matches_jax():
    rng = np.random.default_rng(4)
    fps = _fps(rng, 64)
    counts = rng.integers(-5, 2**32, 40)
    np.testing.assert_array_equal(F.pack_fp12(fps, counts),
                                  JF.pack_fp12(fps, counts))


# -- the resolve (the JAX package's TestResolveKernel, on the port) -----------

def _resolve(fp, keys, valid=None, probe_window=8, rounds=4):
    k = _t(fingerprints(keys).view(np.int32))
    v = (torch.ones(len(keys), dtype=torch.bool) if valid is None
         else _t(np.asarray(valid)))
    return F.fp_resolve(fp, k, v, probe_window=probe_window, rounds=rounds)


def test_insert_then_hit_same_slot():
    fp = F.init_fp_table(64)
    out1 = _resolve(fp, ["alpha", "beta", "gamma"])
    assert out1.resolved.all()
    s1 = out1.slots.clone()
    out2 = _resolve(fp, ["gamma", "alpha", "beta"])
    assert out2.slots.tolist() == [s1[2], s1[0], s1[1]]


def test_distinct_keys_distinct_slots():
    out = _resolve(F.init_fp_table(256), [f"k{i}" for i in range(100)])
    assert out.resolved.all() and len(set(out.slots.tolist())) == 100


def test_in_batch_duplicates_share_slot():
    s = _resolve(F.init_fp_table(64), ["dup", "x", "dup", "dup"]).slots
    assert s[0] == s[2] == s[3] != s[1]


def test_padding_rows_do_not_insert():
    fp = F.init_fp_table(64)
    out = _resolve(fp, ["a", "b"], valid=[True, False])
    assert int((fp != 0).any(1).sum()) == 1 and out.slots[1] == -1
    assert out.resolved.tolist() == [True, True]


def test_window_pressure_reports_unresolved():
    out = _resolve(F.init_fp_table(4), [f"k{i}" for i in range(6)],
                   probe_window=4)
    assert int(out.resolved.sum()) == 4
    assert (out.slots[~out.resolved] == -1).all()


def test_sweep_frees_cells_for_reuse():
    fp = F.init_fp_table(4)
    state = K.init_bucket_state(4)
    out = _resolve(fp, [f"k{i}" for i in range(4)], probe_window=4)
    K.acquire_core(state, out.slots.to(torch.int32),
                   torch.ones(4, dtype=torch.int32),
                   torch.ones(4, dtype=torch.bool), 0, CAP, RATE)
    n_freed = F.fp_sweep_expired(fp, state, 10_000_000, CAP, RATE)
    assert int(n_freed[0]) == 4 and not (fp != 0).any()
    assert _resolve(fp, ["fresh1", "fresh2"], probe_window=4).resolved.all()


def test_peek_does_not_insert():
    fp = F.init_fp_table(64)
    est = F.fp_peek_batch(fp, K.init_bucket_state(64),
                          _t(fingerprints(["ghost"]).view(np.int32)),
                          torch.ones(1, dtype=torch.bool), 0, 7.0, 0.0,
                          probe_window=8)
    assert float(est[0]) == 7.0 and not (fp != 0).any()


def test_migrate_preserves_state():
    fp = F.init_fp_table(8)
    keys = [f"k{i}" for i in range(6)]
    out = _resolve(fp, keys, probe_window=8)
    tokens = torch.arange(8, dtype=torch.float32)
    state = K.BucketState(tokens, torch.zeros(8, dtype=torch.int32),
                          torch.ones(8, dtype=torch.bool))
    new_fp, new_state = F.init_fp_table(16), K.init_bucket_state(16)
    s = out.slots
    _, _, placed = F.fp_migrate_chunk(
        new_fp, new_state, fp[s], tokens[s], state.last_ts[s],
        state.exists[s], torch.ones(6, dtype=torch.bool), probe_window=8)
    assert placed.all()
    re = _resolve(new_fp, keys, probe_window=8)
    np.testing.assert_array_equal(new_state.tokens[re.slots].numpy(),
                                  tokens[s].numpy())


# -- every function against JAX -----------------------------------------------

def _table(rng, n, kind, present):
    """A JAX table with ``present`` keys placed and random state; returns
    (keys, jax fp, jax state) — the port's copies come from ``_port``."""
    keys = _fps(rng, present)
    fp = JF.fp_resolve_core(JF.init_fp_table(n), jnp.asarray(keys),
                            jnp.ones(present, bool), probe_window=16,
                            rounds=4).fp
    if kind == "bucket":
        st = JK.BucketState(
            jnp.asarray(rng.uniform(0, CAP, n).astype(np.float32)),
            jnp.asarray(rng.integers(NOW - 3000, NOW + 50, n).astype(
                np.int32)),
            jnp.asarray(rng.random(n) < 0.7))
    else:
        st = JK.WindowState(
            jnp.asarray(rng.integers(0, 4, n).astype(np.float32)),
            jnp.asarray(rng.integers(0, 4, n).astype(np.float32)),
            jnp.asarray(rng.integers(NOW // WINDOW - 3, NOW // WINDOW + 1,
                                     n).astype(np.int32)),
            jnp.asarray(rng.random(n) < 0.7))
    return keys, fp, st


def _port(fp, st):
    fp_t = _t(np.asarray(fp).view(np.int32)).clone()
    cls = K.BucketState if len(st) == 3 else K.WindowState
    return fp_t, cls(*(_t(np.array(a)) for a in st))


def _same_tables(pfp, pst, jfp, jst, window=False):
    """Cells and every state field equal (window counts are whole)."""
    np.testing.assert_array_equal(pfp.numpy().view(np.uint32),
                                  np.asarray(jfp))
    for name, a, b in zip(pst._fields, pst, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def _rows(rng, keys, m, dist):
    half = min(m // 2, len(keys))
    pool = np.concatenate([keys[:half], _fps(rng, m - half)])
    if dist == "distinct":
        return pool[rng.permutation(len(pool))[:m]]
    return pool[np.minimum(rng.zipf(1.2, m) - 1, len(pool) - 1)]


ULP_LIMIT = np.spacing(np.float32(LIMIT))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n,present", [(256, 60), (4096, 1500), (64, 40)])
@pytest.mark.parametrize("dist", ["distinct", "zipf"])
def test_fp_acquire_batch_matches_jax(seed, n, present, dist):
    rng = np.random.default_rng(seed)
    keys, jfp, jst = _table(rng, n, "bucket", present)
    pfp, pst = _port(jfp, jst)
    rows = _rows(rng, keys, 200, dist)
    counts = rng.integers(0, 4, 200).astype(np.int32)
    valid = rng.random(200) < 0.9
    jfp, jst, g, r, res = JF.fp_acquire_batch(
        jfp, jst, jnp.asarray(rows), jnp.asarray(counts), jnp.asarray(valid),
        jnp.int32(NOW), jnp.float32(CAP), jnp.float32(RATE))
    _, _, pg, pr, pres = F.fp_acquire_batch(
        pfp, pst, _t(rows.view(np.int32)), _t(counts), _t(valid), NOW, CAP,
        RATE)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(g))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(r))
    np.testing.assert_array_equal(pres.numpy(), np.asarray(res))
    _same_tables(pfp, pst, jfp, jst)


@pytest.mark.parametrize("kind", ["bucket", "sliding", "fixed"])
@pytest.mark.parametrize("bits", [False, True])
@pytest.mark.parametrize("seed,n,present", [(0, 4096, 1000), (1, 512, 300),
                                            (2, 128, 100)])
def test_fp_scan_fused_matches_jax(kind, bits, seed, n, present):
    """K = 4 batches of 64 in the 12-byte operand, distinct and repeated,
    new and present keys, padding rows; the small tables run under window
    pressure (unresolved rows, equal on both sides)."""
    rng = np.random.default_rng(seed)
    keys, jfp, jst = _table(rng, n, "bucket" if kind == "bucket"
                            else "window", present)
    pfp, pst = _port(jfp, jst)
    k, b = 4, 64
    rows = _rows(rng, keys, k * b, "zipf" if seed % 2 else "distinct")
    counts = rng.integers(0, 3, k * b)
    counts[rng.random(k * b) < 0.1] = -1
    fused = F.pack_fp12(rows, np.zeros(0))
    fused[:, 2] = counts.astype(np.int64).astype(np.uint32)
    fused = fused.reshape(k, b, 3)
    nows = (NOW + np.arange(k) * 300).astype(np.int32)
    if kind == "bucket":
        fn = JF.fp_acquire_scan_fused_bits if bits else JF.fp_acquire_scan_fused
        jfp, jst, want = fn(jfp, jst, jnp.asarray(fused), jnp.asarray(nows),
                            jnp.float32(CAP), jnp.float32(RATE))
        got = ck.fp_acquire_scan(pfp, pst, _t(fused.view(np.int32)),
                                 _t(nows), CAP, RATE,
                                 with_remaining=not bits)
    else:
        fn = (JF.fp_window_acquire_scan_fused_bits if bits
              else JF.fp_window_acquire_scan_fused)
        jfp, jst, want = fn(jfp, jst, jnp.asarray(fused), jnp.asarray(nows),
                            jnp.float32(LIMIT), jnp.int32(WINDOW),
                            interpolate=kind == "sliding")
        got = ck.fp_window_scan(pfp, pst, _t(fused.view(np.int32)),
                                _t(nows), LIMIT, WINDOW,
                                interpolate=kind == "sliding",
                                with_remaining=not bits)
    got, want = got.numpy(), np.asarray(want)
    if bits:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        tol = ULP_LIMIT * 1.5 if kind == "sliding" else 0
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=tol)
    if n == 128:  # window pressure: some rows unresolved on both sides
        unresolved = (np.unpackbits(want[:, 1].reshape(-1),
                                    bitorder="little") == 0 if bits
                      else want[:, 0] < 2)
        assert unresolved.any()
    _same_tables(pfp, pst, jfp, jst, window=kind != "bucket")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [4096, 64])
def test_fp_debit_matches_jax(seed, n):
    """Debits with refunds and repeated keys, whole amounts (the prefix
    sums are exact in both orders); the 64-slot table runs under window
    pressure (unresolved rows report their amount as shortfall)."""
    rng = np.random.default_rng(seed)
    keys, jfp, jst = _table(rng, n, "bucket", min(n // 2, 1000))
    pfp, pst = _port(jfp, jst)
    rows = _rows(rng, keys, 300, "zipf")
    amounts = rng.integers(-3, 6, 300).astype(np.float32)
    valid = rng.random(300) < 0.95
    jfp, jst, want = JF.fp_debit_batch(
        jfp, jst, jnp.asarray(rows), jnp.asarray(amounts),
        jnp.asarray(valid), jnp.int32(NOW), jnp.float32(CAP),
        jnp.float32(RATE))
    packed = np.zeros((4, 300), np.int32)
    packed[0] = np.where(valid, 0, -1)
    packed[1] = amounts.view(np.int32)
    packed[2] = NOW
    got = ck.fp_debit(pfp, pst, _t(rows.view(np.int32)), _t(packed), CAP,
                      RATE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _same_tables(pfp, pst, jfp, jst)


@pytest.mark.parametrize("seed", range(3))
def test_fp_peek_matches_jax(seed):
    rng = np.random.default_rng(seed)
    keys, jfp, jst = _table(rng, 1024, "bucket", 500)
    pfp, pst = _port(jfp, jst)
    rows = _rows(rng, keys, 256, "distinct")
    valid = rng.random(256) < 0.9
    want = JF.fp_peek_batch(jfp, jst, jnp.asarray(rows), jnp.asarray(valid),
                            jnp.int32(NOW), jnp.float32(CAP),
                            jnp.float32(RATE))
    got = ck.fp_peek(pfp, pst, _t(rows.view(np.int32)), _t(valid), NOW, CAP,
                     RATE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _same_tables(pfp, pst, jfp, jst)


@pytest.mark.parametrize("kind", ["bucket", "window"])
@pytest.mark.parametrize("later", [1024, 4 * 1024, 60 * 1024])
def test_fp_sweeps_match_jax(kind, later):
    rng = np.random.default_rng(later)
    keys, jfp, jst = _table(rng, 1024, kind, 600)
    pfp, pst = _port(jfp, jst)
    if kind == "bucket":
        jfp, jst, want = JF.fp_sweep_expired(
            jfp, jst, jnp.int32(NOW + later), jnp.float32(CAP),
            jnp.float32(RATE))
        got = ck.fp_sweep_expired(pfp, pst, NOW + later, CAP, RATE)
    else:
        jfp, jst, want = JF.fp_sweep_windows(jfp, jst, jnp.int32(NOW + later),
                                             jnp.int32(WINDOW))
        got = ck.fp_sweep_windows(pfp, pst, NOW + later, WINDOW)
    assert got.shape == (1,) and int(got[0]) == int(want)
    _same_tables(pfp, pst, jfp, jst)


@pytest.mark.parametrize("kind", ["bucket", "window"])
@pytest.mark.parametrize("new_n", [64, 2048])
def test_fp_migrate_matches_jax(kind, new_n):
    """A chunk of an old table's entries claimed in a new table with their
    state columns; at 64 slots some stay unplaced on both sides."""
    rng = np.random.default_rng(new_n)
    keys, jfp, jst = _table(rng, 1024, kind, 300)
    old = np.asarray(jfp)
    cells = np.nonzero((old != 0).any(1))[0][:256]
    cols = [np.asarray(a)[cells] for a in jst]
    valid = rng.random(len(cells)) < 0.95
    if kind == "bucket":
        nfp, nst = JF.init_fp_table(new_n), JK.init_bucket_state(new_n)
        fn = JF.fp_migrate_chunk
    else:
        nfp, nst = JF.init_fp_table(new_n), JK.init_window_state(new_n)
        fn = JF.fp_migrate_window_chunk
    pfp, pst = _port(nfp, nst)
    nfp, nst, want = fn(nfp, nst, jnp.asarray(old[cells]),
                        *(jnp.asarray(c) for c in cols), jnp.asarray(valid))
    got = ck.fp_migrate(pfp, pst, _t(old[cells].view(np.int32)),
                        [_t(c) for c in cols], _t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if new_n == 64:
        assert not np.asarray(want)[valid].all()
    _same_tables(pfp, pst, nfp, nst)


def _routed_table(rng, n, n_shards, kind, present):
    """An old table of ``n`` cells in ``n_shards`` regions holding
    ``present`` keys (each in its region, placed by the plain resolve) with
    random state on its live cells only. Returns (keys, fp u32[n, 2],
    numpy state columns)."""
    keys = _fps(rng, present)
    fp = F.init_fp_table(n)
    F.fp_resolve(fp, _t(keys.view(np.int32)),
                 torch.ones(present, dtype=torch.bool), probe_window=16,
                 rounds=4, n_shards=n_shards)
    fp = fp.numpy().view(np.uint32).copy()
    live = (fp != 0).any(1)
    if kind == "bucket":
        cols = [rng.uniform(0, CAP, n).astype(np.float32),
                rng.integers(NOW - 3000, NOW + 50, n).astype(np.int32),
                rng.random(n) < 0.7]
    else:
        cols = [rng.integers(0, 4, n).astype(np.float32),
                rng.integers(0, 4, n).astype(np.float32),
                rng.integers(NOW // WINDOW - 3, NOW // WINDOW + 1,
                             n).astype(np.int32),
                rng.random(n) < 0.7]
    for c in cols:
        c[~live] = 0
    return keys, fp, cols


def _jax_rehash_pass(jtabs, old, cols, pending, b, kind):
    """One pass of JAX's ``_rehash`` loop (``runtime/fp_store.py``; with
    shard regions ``parallel/fp_sharded.py``'s ``_rehash_locked``, each
    region its own table): each region's pending rows in chunks of ``b``
    through ``fp_migrate_chunk`` / ``fp_migrate_window_chunk``. Returns each
    region's rows left unplaced."""
    fn = JF.fp_migrate_chunk if kind == "bucket" else \
        JF.fp_migrate_window_chunk
    left = []
    for s, idx_s in enumerate(pending):
        miss = []
        for pos in range(0, len(idx_s), b):
            idx = idx_s[pos:pos + b]
            m = len(idx)
            kp = np.zeros((b, 2), np.uint32)
            kp[:m] = old[idx]
            chunk = []
            for c in cols:
                col = np.zeros((b,), c.dtype)
                col[:m] = c[idx]
                chunk.append(jnp.asarray(col))
            valid = np.zeros((b,), bool)
            valid[:m] = True
            jfp, jst, placed = fn(*jtabs[s], jnp.asarray(kp), *chunk,
                                  jnp.asarray(valid), probe_window=16,
                                  rounds=4)
            jtabs[s] = (jfp, jst)
            miss.append(idx[~np.asarray(placed)[:m]])
        left.append(np.concatenate(miss) if miss else idx_s[:0])
    return left


@pytest.mark.parametrize("kind", ["bucket", "window"])
@pytest.mark.parametrize("n_shards", [1, 8])
@pytest.mark.parametrize("grow", [1, 2])
def test_fp_migrate_table_matches_jax_passes(kind, n_shards, grow):
    """The table form's plain version, pass by pass, against JAX's growth
    loop over the same old table: the new table slot for slot and column
    for column, and the rows left unplaced, after each pass. Re-placing at
    the old size (``grow`` 1: a dense table, chunks of 64 under contention)
    leaves rows for a second pass; doubling (``grow`` 2) too, rarely."""
    rng = np.random.default_rng(40 + 2 * n_shards + grow)
    n_old = 1024
    _, old, cols = _routed_table(rng, n_old, n_shards, kind, 700)
    n_new = grow * n_old
    per_new = n_new // n_shards
    init = JK.init_bucket_state if kind == "bucket" else \
        JK.init_window_state
    jtabs = [(JF.init_fp_table(per_new), init(per_new))
             for _ in range(n_shards)]
    pinit = K.init_bucket_state if kind == "bucket" else K.init_window_state
    pfp, pst = F.init_fp_table(n_new), pinit(n_new)
    old_t = _t(old.view(np.int32))
    old_st = type(pst)(*(_t(c) for c in cols))
    live = np.nonzero((old != 0).any(1))[0]
    per_old = n_old // n_shards
    pending = [live[live // per_old == s] for s in range(n_shards)]
    source = None
    passes = 0
    while True:
        pending = _jax_rehash_pass(jtabs, old, cols, pending, 64, kind)
        source, left = F.fp_migrate_table(
            pfp, pst, old_t, old_st, probe_window=16, rounds=4,
            n_shards=n_shards, source=source, chunk=64)
        passes += 1
        want = np.concatenate(pending)
        assert left == len(want)
        np.testing.assert_array_equal(source.numpy(), want)
        np.testing.assert_array_equal(
            pfp.numpy().view(np.uint32),
            np.concatenate([np.asarray(t[0]) for t in jtabs]))
        for j, (name, col) in enumerate(zip(pst._fields, pst)):
            np.testing.assert_array_equal(
                col.numpy(), np.concatenate([np.asarray(t[1][j])
                                             for t in jtabs]), name)
        if not left or passes == 4:
            break
    if grow == 1:
        assert passes >= 2  # the retry pass ran
    F.check_table_np(pfp.numpy().view(np.uint32), 16, n_shards)


def test_fp_migrate_table_wrapper_is_the_plain_version_on_the_cpu():
    """``cuda_kernels.fp_migrate_table`` on CPU tensors is the plain
    version (no launch counted); its source list comes back as ``i32``."""
    rng = np.random.default_rng(5)
    _, old, cols = _routed_table(rng, 256, 1, "bucket", 120)
    before = dict(ck.launches)
    a = (F.init_fp_table(512), K.init_bucket_state(512))
    b = (F.init_fp_table(512), K.init_bucket_state(512))
    old_st = K.BucketState(*(_t(c) for c in cols))
    got = ck.fp_migrate_table(*a, _t(old.view(np.int32)), old_st, chunk=32)
    want = F.fp_migrate_table(*b, _t(old.view(np.int32)), old_st, chunk=32)
    assert ck.launches == before
    assert got[1] == want[1] == 0 and got[0].dtype == torch.int32
    assert torch.equal(a[0], b[0])
    assert F.check_table_np(a[0].numpy().view(np.uint32), 16) == 120


# -- the wrappers' device rule ------------------------------------------------

def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A CPU table runs the plain version and counts no launch; a table on
    another device raises: there is no fallback to the plain version."""
    before = dict(ck.launches)
    fp, st = F.init_fp_table(64), K.init_bucket_state(64)
    kp = _t(_fps(np.random.default_rng(1), 8).view(np.int32))
    ck.fp_peek(fp, st, kp, torch.ones(8, dtype=torch.bool), 0, CAP, RATE)
    ck.fp_sweep_expired(fp, st, 0, CAP, RATE)
    assert ck.launches == before
    meta = K.BucketState(*(t.to("meta") for t in st))
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        ck.fp_sweep_expired(fp.to("meta"), meta, 0, CAP, RATE)
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        ck.fp_acquire_scan(fp.to("meta"), meta,
                           torch.zeros((1, 8, 3), dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), CAP, RATE)
