"""The port's wire codec against the JAX package's, byte for byte.

Seeded frames for every op, every tail (trace, deadline, attempt) and every
bulk variant (kinds, chained, remaining, the tenant extension, the bulk
deadline tail, chunk spans of one blob) are encoded by both packages and
must be identical; each package decodes the other's frames to the same
values. Keys include non-UTF-8 bytes carried as ``surrogateescape`` strings.
The key directories — the port's native and Python ones and the JAX native
one — must resolve a ``KeyBlob`` to the same slots. Tolerance: exact
(bytes, values and slots).
"""

import asyncio

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.runtime import wire as jw
from distributedratelimiting.redis_tpu.runtime.directory import (
    NativeKeyDirectory as JNativeDirectory,
)
from distributedratelimiting.redis_tpu.utils.native import (
    load_directory_lib as j_load_directory_lib,
)
from distributedratelimiting.redis_tpu_torch.runtime import wire as pw
from distributedratelimiting.redis_tpu_torch.runtime.directory import (
    NativeKeyDirectory,
    PyKeyDirectory,
)
from distributedratelimiting.redis_tpu_torch.utils.native import (
    load_directory_lib,
)

torch.set_num_threads(1)

#: A key that is not UTF-8: bytes 0xff 0xfe carried as lone surrogates.
BAD_KEY = b"user:\xff\xfe:1".decode("utf-8", "surrogateescape")
TRACE = (0x0123456789ABCDEF, 0xFEDCBA9876543210, 0x1122334455667788, 1)


def _keys(rng, n):
    """Seeded keys: ascii, non-ascii UTF-8, the non-UTF-8 one, repeats."""
    pool = [f"k{i}" for i in range(n)] + ["ключ-🔑", BAD_KEY, ""]
    return [pool[i] for i in rng.integers(0, len(pool), n)]


def test_every_constant_is_identical():
    names = [n for n in dir(jw) if n.isupper() and not n.startswith("_")]
    assert {"OP_ACQUIRE_MANY", "RESP_BULK", "BULK_KIND_HBUCKET",
            "PROTOCOL_VERSION", "MAX_FRAME", "TEXT_OPS"} <= set(names)
    for n in names:
        assert getattr(pw, n) == getattr(jw, n), n
    assert set(pw.__all__) == set(jw.__all__)
    for op in range(0, 30):
        assert pw.op_name(op) == jw.op_name(op)


_SCALAR = [
    (jw.OP_ACQUIRE, "user:42", 3, 100.0, 5.0),
    (jw.OP_WINDOW, "w", 1, 10.0, 1.5),
    (jw.OP_FWINDOW, "fw", 2, 10.0, 60.0),
    (jw.OP_SEMA, "s", -1, 4.0, 0.0),
    (jw.OP_PEEK, "ключ-🔑", 0, 7.0, 0.25),
    (jw.OP_SYNC, BAD_KEY, 0, 12.5, 1.0),
    (jw.OP_HELLO, "secret", 0, 0.0, 0.0),
    (jw.OP_PING, "", 0, 0.0, 0.0),
    (jw.OP_SAVE, "", 0, 0.0, 0.0),
    (jw.OP_METRICS, "", 0, 0.0, 0.0),
    (jw.OP_PLACEMENT, "", 0, 0.0, 0.0),
    (jw.OP_STATS, "", 0, 0.0, 0.0),
    (jw.OP_STATS, "", 3, 0.0, 0.0),
    (jw.OP_TRACES, "", 1, 0.0, 0.0),
] + [(op, '{"rid": "r1", "n": [1, 2]}', 0, 0.0, 0.0)
     for op in sorted(jw.TEXT_OPS)]


@pytest.mark.parametrize("tails", [(None, None, 0), (TRACE, None, 0),
                                   (None, 0.25, 0), (None, None, 2),
                                   (TRACE, 1.5, 7), (None, 0.5, 300)])
@pytest.mark.parametrize("req", _SCALAR, ids=lambda r: jw.op_name(r[0]))
def test_scalar_request_bytes_and_cross_decode(req, tails):
    trace, deadline, attempt = tails
    op, key, count, a, b = req
    kw = dict(trace=trace, deadline_s=deadline, attempt=attempt)
    jf = jw.encode_request(9, op, key, count, a, b, **kw)
    pf = pw.encode_request(9, op, key, count, a, b, **kw)
    assert pf == jf
    for mine, theirs in ((pw, jw), (jw, pw)):
        body, ctx = mine.strip_trace(jf[4:])
        body, ddl = mine.strip_deadline(body)
        body, att = mine.strip_attempt(body)
        assert (ctx is None) == (trace is None)
        if ctx is not None:
            assert tuple(ctx) == trace
        assert ddl == deadline and att == min(attempt, 255)
        assert mine.decode_request(body) == theirs.decode_request(body)
        assert mine.decode_request(body)[:3] == (9, op, key if op not in (
            jw.OP_PING, jw.OP_SAVE, jw.OP_METRICS, jw.OP_PLACEMENT,
            jw.OP_STATS, jw.OP_TRACES) else "")


@pytest.mark.parametrize("tails", [(None, None, 0), (TRACE, 2.0, 3)])
def test_hierarchical_request_bytes(tails):
    trace, deadline, attempt = tails
    hier = ("tenant-ä", 500.0, 50.0, 2)
    kw = dict(trace=trace, deadline_s=deadline, attempt=attempt, hier=hier)
    jf = jw.encode_request(3, jw.OP_ACQUIRE_H, "k", 4, 10.0, 1.0, **kw)
    assert pw.encode_request(3, jw.OP_ACQUIRE_H, "k", 4, 10.0, 1.0,
                             **kw) == jf
    body = pw.strip_attempt(pw.strip_deadline(pw.strip_trace(jf[4:])[0])[0])[0]
    assert (pw.decode_hierarchical_request(body)
            == jw.decode_hierarchical_request(body)
            == (3, "k", 4, 10.0, 1.0) + hier)


def test_unknown_and_malformed_requests_raise_alike():
    for body in (bytes([4, 1, 0, 0, 0, 99]), bytes([4, 1, 0, 0, 0, 0xC1])):
        msgs = []
        for w in (pw, jw):
            with pytest.raises(w.RemoteStoreError) as exc:
                w.decode_request(body)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1] and msgs[0].startswith("unknown op")
    bad_ver = bytes([3, 1, 0, 0, 0, 5])
    for w in (pw, jw):
        with pytest.raises(w.ProtocolVersionError):
            w.decode_request(bad_ver)
    for w in (pw, jw):
        with pytest.raises(w.RemoteStoreError):
            w.strip_trace(bytes([4, 1, 0, 0, 0, 0x81, 0]))


_RESPONSES = [
    (jw.RESP_DECISION, (True, 4.5)), (jw.RESP_DECISION, (False, 0.0)),
    (jw.RESP_VALUE, (3.25,)), (jw.RESP_PAIR, (1.5, 2.5)),
    (jw.RESP_EMPTY, ()), (jw.RESP_ERROR, ("boom: ключ",)),
    (jw.RESP_ERROR, ("é" * 40000,)), (jw.RESP_TEXT, ('{"a": 1}',)),
]


@pytest.mark.parametrize("resp", _RESPONSES, ids=lambda r: str(r[0]))
def test_response_bytes_and_cross_decode(resp):
    kind, vals = resp
    jf = jw.encode_response(11, kind, *vals)
    assert pw.encode_response(11, kind, *vals) == jf
    assert pw.decode_response(jf[4:]) == jw.decode_response(jf[4:])


@pytest.mark.parametrize("with_remaining", [True, False])
@pytest.mark.parametrize("n", [0, 1, 13, 257])
def test_bulk_response_bytes_and_cross_decode(n, with_remaining):
    rng = np.random.default_rng(n)
    granted = rng.random(n) < 0.6
    remaining = (rng.uniform(0, 100, n).astype(np.float32)
                 if with_remaining else None)
    jf = jw.encode_bulk_response(5, granted, remaining)
    assert pw.encode_bulk_response(5, granted, remaining) == jf
    for w in (pw, jw):
        seq, kind, (g, r) = w.decode_response(jf[4:])
        assert (seq, kind) == (5, jw.RESP_BULK)
        np.testing.assert_array_equal(g, granted)
        if with_remaining:
            np.testing.assert_array_equal(r, remaining)
        else:
            assert r is None


_BULK = [
    dict(),
    dict(with_remaining=False),
    dict(kind=jw.BULK_KIND_WINDOW),
    dict(kind=jw.BULK_KIND_FWINDOW, chained=True),
    dict(trace=TRACE),
    dict(deadline_s=0.75, attempt=2),
    dict(trace=TRACE, deadline_s=0.5, attempt=400, chained=True),
    dict(kind=jw.BULK_KIND_HBUCKET, hier=("t", 100.0, 10.0, 1)),
    dict(kind=jw.BULK_KIND_HBUCKET, hier=("t", 100.0, 10.0, 1),
         trace=TRACE, deadline_s=1.0),
]


@pytest.mark.parametrize("kw", _BULK, ids=lambda kw: ",".join(sorted(kw)))
def test_bulk_request_bytes_and_cross_decode(kw):
    rng = np.random.default_rng(len(kw))
    keys = _keys(rng, 40)
    counts = rng.integers(0, 300, len(keys)).astype(np.int64)
    blobs = [k.encode("utf-8", "surrogateescape") for k in keys]
    jf = jw.encode_bulk_request(77, blobs, counts, 100.0, 5.0, **kw)
    assert pw.encode_bulk_request(77, blobs, counts, 100.0, 5.0, **kw) == jf
    body = jf[4:]
    for w in (pw, jw):
        assert w.bulk_request_chained(body) == bool(kw.get("chained"))
        ctx = w.bulk_trace_tail(body)
        assert (tuple(ctx) if ctx else None) == kw.get("trace")
        tail = w.bulk_deadline_tail(body)
        if "deadline_s" in kw:
            assert tail == (kw["deadline_s"], min(kw.get("attempt", 0), 255))
        else:
            assert tail is None
        if "hier" in kw:
            assert w.bulk_hier_tail(body) == kw["hier"]
        seq, got, c, a, b, rem, kind = w.decode_bulk_request(body)
        assert (seq, got, a, b, rem, kind) == (
            77, keys, 100.0, 5.0, kw.get("with_remaining", True),
            kw.get("kind", jw.BULK_KIND_BUCKET))
        np.testing.assert_array_equal(c, counts)
        view = w.decode_bulk_request(body, as_view=True)[1]
        assert len(view) == len(keys) and list(view) == keys
        assert view.tolist() == keys and view[-1] == keys[-1]


@pytest.mark.parametrize("budget", [64, 300, None])
def test_bulk_chunk_spans_and_span_frames(budget):
    rng = np.random.default_rng(7)
    keys = _keys(rng, 500)
    blobs = [k.encode("utf-8", "surrogateescape") for k in keys]
    klens = np.fromiter(map(len, blobs), np.int64, len(blobs))
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum(klens, out=offsets[1:])
    counts = rng.integers(0, 9, len(keys)).astype(np.uint32)
    spans = jw.bulk_chunk_spans(klens, budget)
    assert pw.bulk_chunk_spans(klens, budget) == spans
    assert spans[0][0] == 0 and spans[-1][1] == len(keys)
    blob = b"".join(blobs)
    for i, (s, e) in enumerate(spans):
        kw = dict(chained=i > 0, trace=TRACE if i % 2 else None)
        jf = jw.encode_bulk_request_span(i, blob, offsets, klens, counts, s,
                                         e, 10.0, 1.0, **kw)
        assert pw.encode_bulk_request_span(i, blob, offsets, klens, counts,
                                           s, e, 10.0, 1.0, **kw) == jf
        assert pw.decode_bulk_request(jf[4:])[1] == keys[s:e]


def test_bulk_encoder_errors_alike():
    for w in (pw, jw):
        with pytest.raises(ValueError):
            w.encode_bulk_request(1, [b"x"], [1], 1.0, 1.0, kind=7)
        with pytest.raises(ValueError):
            w.encode_bulk_request(1, [b"x"], [1], 1.0, 1.0,
                                  kind=jw.BULK_KIND_HBUCKET)
        with pytest.raises(ValueError):
            w.encode_bulk_request(1, [b"x" * 70000], [1], 1.0, 1.0)
        with pytest.raises(w.RemoteStoreError):
            w.decode_bulk_request(jw.encode_bulk_request(
                1, [b"abc"], [1], 1.0, 1.0)[4:-6])


def test_key_blob_surrogateescape_round_trip():
    keys = [BAD_KEY, "plain", "ключ", b"\xc3(".decode("utf-8",
                                                      "surrogateescape")]
    blobs = [k.encode("utf-8", "surrogateescape") for k in keys]
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    blob = b"".join(blobs)
    pv, jv = pw.KeyBlob(blob, offsets), jw.KeyBlob(blob, offsets)
    assert list(pv) == list(jv) == keys
    assert [pv[i] for i in range(-4, 4)] == [jv[i] for i in range(-4, 4)]
    with pytest.raises(IndexError):
        pv[4]
    assert (pw.decode_key_blob(blob, np.diff(offsets),
                               errors="surrogateescape")
            == jw.decode_key_blob(blob, np.diff(offsets),
                                  errors="surrogateescape") == keys)


def test_read_and_write_frame_round_trip():
    frame = pw.encode_request(5, pw.OP_ACQUIRE, "k", 1, 2.0, 3.0)

    class _Sink:
        data = b""

        def write(self, b):
            self.data += b

    sink = _Sink()
    pw.write_frame(sink, frame)

    async def read(data):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return await pw.read_frame(reader), await jw.read_frame(reader)

    body, eof = asyncio.run(read(sink.data))
    assert body == frame[4:] and eof is None
    with pytest.raises(pw.RemoteStoreError):
        asyncio.run(read((pw.MAX_FRAME + 1).to_bytes(4, "little")))


def _directories(n_slots):
    lib, jlib = load_directory_lib(), j_load_directory_lib()
    assert lib is not None and jlib is not None
    return {"port native": NativeKeyDirectory(n_slots, lib),
            "port python": PyKeyDirectory(n_slots),
            "jax native": JNativeDirectory(n_slots, jlib)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_directories_resolve_a_key_blob_to_the_same_slots(seed):
    rng = np.random.default_rng(seed)
    dirs = _directories(48)
    got = {name: [] for name in dirs}
    for step in range(6):
        keys = _keys(rng, 40)
        blobs = [k.encode("utf-8", "surrogateescape") for k in keys]
        frame = jw.encode_bulk_request(step, blobs, np.ones(len(keys)),
                                       1.0, 1.0)
        jview = jw.decode_bulk_request(frame[4:], as_view=True)[1]
        pview = pw.decode_bulk_request(frame[4:], as_view=True)[1]
        for name, d in dirs.items():
            view = jview if name == "jax native" else pview
            slots = d.resolve_batch(view)
            # The blob and the strings resolve alike.
            assert np.array_equal(slots, d.resolve_batch(list(view)))
            dead = slots[(slots >= 0) & (slots % 3 == step % 3)]
            got[name].append((slots.copy(), d.remove_slots(dead),
                              d.free_count, len(d)))
    ref = got["jax native"]
    for name, rows in got.items():
        for (s, r, f, n), (s0, r0, f0, n0) in zip(rows, ref):
            assert np.array_equal(s, s0), name
            assert (r, f, n) == (r0, f0, n0), name
