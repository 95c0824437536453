"""The port's key directories against the JAX package's native directory.

The same seeded op streams — resolve, exhaustion to -1, ``remove_slots``,
``add_slots``, ``load``, ``to_dict``, unicode and surrogate-escaped keys —
run through three directories: the port's ``NativeKeyDirectory`` (built from
``native/directory.cc`` into the port's own build directory), the port's
``PyKeyDirectory``, and the JAX package's ``NativeKeyDirectory``. Slots,
maps, ``free_count`` and ``len`` must be identical after every step.
Mirrors ``tests/test_directory.py``.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from distributedratelimiting.redis_tpu.runtime.directory import (
    NativeKeyDirectory as JNative,
)
from distributedratelimiting.redis_tpu.utils.native import (
    load_directory_lib as jax_lib,
)
from distributedratelimiting.redis_tpu_torch import DeviceBucketStore, ManualClock
from distributedratelimiting.redis_tpu_torch.runtime import directory as D
from distributedratelimiting.redis_tpu_torch.utils import native

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _trio(n_slots):
    lib = native.load_directory_lib()
    assert lib is not None, "the native directory must build here"
    return [D.NativeKeyDirectory(n_slots, lib), D.PyKeyDirectory(n_slots),
            JNative(n_slots, jax_lib())]


def _same(dirs, results=None):
    if results is not None:
        for r in results[1:]:
            np.testing.assert_array_equal(r, results[0])
    first = dirs[0]
    for d in dirs[1:]:
        assert len(d) == len(first)
        assert d.free_count == first.free_count
        assert d.to_dict() == first.to_dict()


def _resolve(dirs, keys):
    out = [d.resolve_batch(list(keys)) for d in dirs]
    _same(dirs, out)
    return out[0]


def test_library_builds_into_the_port_build_dir():
    lib = native.load_directory_lib()
    assert lib is not None and lib.has_pylist
    path = pathlib.Path(lib._name)
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libdirectory-")
    # The committed binaries under native/build/ are not the port's.
    assert not path.is_relative_to(ROOT / "native")


def test_allocation_order_exhaustion_and_lookup():
    dirs = _trio(4)
    slots = _resolve(dirs, [f"k{i}" for i in range(6)] + ["k3", "k0"])
    assert slots.tolist() == [0, 1, 2, 3, -1, -1, 3, 0]
    for k in ("k1", "k5"):
        assert len({d.lookup(k) for d in dirs}) == 1


def test_remove_recycle_and_grow():
    dirs = _trio(8)
    _resolve(dirs, [f"k{i}" for i in range(8)])
    removed = [d.remove_slots(np.array([1, 3, 5, 3], np.int32)) for d in dirs]
    assert removed == [3, 3, 3]
    assert [d.remove_slots([]) for d in dirs] == [0, 0, 0]
    _same(dirs)
    # LIFO reuse: the last slot freed is handed out first.
    assert _resolve(dirs, ["n1", "n2", "n3"]).tolist() == [5, 3, 1]
    for d in dirs:
        d.add_slots(8, 16)
    assert (_resolve(dirs, ["g1", "g2"]) >= 8).all()


def test_load_and_to_dict_roundtrip():
    dirs = _trio(16)
    _resolve(dirs, [f"key-{i}" for i in range(12)])
    for d in dirs:
        d.remove_slots([2, 7])
    snap = dirs[2].to_dict()
    fresh = _trio(4)
    for d in fresh:
        d.load(snap, 16)
    _same(fresh)
    assert fresh[0].to_dict() == snap
    _resolve(fresh, ["x", "y", "key-3"])


def test_unicode_long_and_surrogate_escaped_keys():
    dirs = _trio(8)
    # A lone surrogate is how a byte-identity key arrives as a str; the
    # native directories store its surrogateescape bytes.
    keys = ["ключ", "🔑" * 40, "a" * 500, "", "raw\udcff\udcfe", "ключ"]
    _resolve(dirs, keys)
    assert "raw\udcff\udcfe" in dirs[0].to_dict()
    for d in dirs:
        d.remove_slots([4])
    _resolve(dirs, ["raw\udcff\udcfe"])


@pytest.mark.parametrize("seed", range(4))
def test_seeded_lifecycle_matches(seed):
    rng = np.random.default_rng(seed)
    n_slots = 32
    dirs = _trio(n_slots)
    for step in range(300):
        op = rng.integers(0, 11)
        if op < 6:
            _resolve(dirs, [f"k{rng.integers(0, 64)}"
                            for _ in range(rng.integers(1, 12))])
        elif op < 8:
            dead = rng.integers(0, n_slots, rng.integers(1, 6)).astype(
                np.int32)
            assert len({d.remove_slots(dead) for d in dirs}) == 1
        elif op == 8 and n_slots < 256:
            for d in dirs:
                d.add_slots(n_slots, n_slots * 2)
            n_slots *= 2
        elif op == 9:
            snap = dirs[0].to_dict()
            for d in dirs:
                d.load(snap, n_slots)
        else:
            for k in [f"k{rng.integers(0, 64)}" for _ in range(4)]:
                assert len({d.lookup(k) for d in dirs}) == 1
        _same(dirs)


def test_arena_compaction_under_key_churn():
    nd = _trio(8)[0]
    for gen in range(200):
        slots = nd.resolve_batch([f"generation-{gen}-user-{i}"
                                  for i in range(8)])
        assert (slots >= 0).all()
        nd.remove_slots(slots)
    final = [f"final-{i}" for i in range(8)]
    nd.resolve_batch(final)
    assert len(nd) == 8 and nd.arena_bytes == sum(len(k) for k in final)


def test_store_resolves_every_table_natively():
    store = DeviceBucketStore(device="cpu", clock=ManualClock(0), n_slots=8)
    store.acquire_blocking("k", 1, 10.0, 1.0)
    store.sync_counter_blocking("c", 1.0, 1.0)
    assert isinstance(next(iter(store._tables.values())).dir,
                      D.NativeKeyDirectory)
    assert isinstance(store._counter_dir, D.NativeKeyDirectory)


def test_no_native_env_gives_the_python_directory(monkeypatch):
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("DRL_TPU_NO_NATIVE", "1")
    assert native.load_directory_lib() is None
    assert isinstance(D.make_directory(8), D.PyKeyDirectory)
    store = DeviceBucketStore(device="cpu", clock=ManualClock(0))
    assert isinstance(store._counter_dir, D.PyKeyDirectory)


def test_build_failure_falls_back_with_a_warning(monkeypatch, tmp_path,
                                                 caplog):
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cc")
    assert native.load_directory_lib() is None
    assert "falling back to the Python directory" in caplog.text
    assert isinstance(D.make_directory(8), D.PyKeyDirectory)


def test_two_processes_building_at_once_both_load(tmp_path):
    code = (
        "import pathlib, sys\n"
        "from distributedratelimiting.redis_tpu_torch.utils import native\n"
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "lib = native.load_directory_lib()\n"
        "h = lib.dir_new(4)\n"
        "print(lib.dir_free_count(h))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("DRL_TPU_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["4"]
    built = sorted(f.name for f in tmp_path.iterdir())
    assert len(built) == 1 and built[0].endswith(".so"), built
