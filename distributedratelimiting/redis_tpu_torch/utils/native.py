"""Loaders for the repository's two native host libraries.

The port's half of the JAX package's ``utils/native.py``: the key directory
(``native/directory.cc``) and the serving front-end (``native/frontend.cc``).
Both are host C++ shared by the repository; the port compiles them where
they lie and never copies or edits them. Each library is built with ``g++``
at first use into the port's own (git-ignored) ``build/`` directory, never
into ``native/build/``, whose binaries are committed:

- the file name carries a hash of the source and the flags, so a changed
  source builds a new file instead of loading a stale one;
- ``g++`` writes to a per-process temporary name that is then renamed into
  place, so several processes building at once each load a whole file;
- the directory's build adds ``-DDRL_WITH_PYTHON`` when ``Python.h``
  exists, so that ``dir_resolve_pylist`` reads each ``str``'s cached UTF-8
  with no copy; that library is then loaded with ``ctypes.PyDLL``, since
  the call reads Python objects under the GIL.

The directory is optional: any failure (no compiler, read-only checkout)
yields ``None`` and a logged warning, and callers fall back to the Python
directory; ``DRL_TPU_NO_NATIVE=1`` forces that fallback. The front-end is
not optional: :func:`load_frontend_lib` raises with ``g++``'s error when it
cannot build, and ``DRL_TPU_NO_NATIVE`` does not turn it off. It is loaded
as a plain ``ctypes.CDLL`` — never ``PyDLL`` — so that its blocking
``fe_wait`` releases the GIL and a pump thread waiting in it never stalls
the event loop. Its whole ABI is bound: the library is built from the
source beside it, so there is no older binary to probe for. The sanitizer
builds are not ported.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import sysconfig
import threading

__all__ = ["BUILD_DIR", "FRONTEND_SOURCE", "SOURCE", "URING_OFF",
           "URING_ON", "URING_SQPOLL", "frontend_lib_path",
           "load_directory_lib", "load_frontend_lib"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
#: The shared host source, compiled where it lies.
SOURCE = _PKG.parents[1] / "native" / "directory.cc"
#: The serving front-end's source, compiled where it lies.
FRONTEND_SOURCE = _PKG.parents[1] / "native" / "frontend.cc"
BUILD_DIR = _PKG / "build"

#: Transport mode of ``fe_start_sharded2``: the ``kUringOff`` /
#: ``kUringOn`` / ``kUringSqpoll`` constants of ``native/frontend.cc``.
URING_OFF = 0
URING_ON = 1
URING_SQPOLL = 2
_BASE_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_LIB: ctypes.CDLL | None = None
_TRIED = False
#: Serializes the first load across threads: a racing first caller must not
#: see ``_TRIED`` set by a loader still mid-build.
_LOAD_LOCK = threading.Lock()


def _python_flags() -> list[str]:
    """``-DDRL_WITH_PYTHON -I<include>`` when ``Python.h`` exists."""
    include = sysconfig.get_paths().get("include")
    if include and (pathlib.Path(include) / "Python.h").exists():
        return ["-DDRL_WITH_PYTHON", f"-I{include}"]
    return []


def _lib_path(flags: list[str], source: "pathlib.Path | None" = None,
              stem: str = "libdirectory") -> pathlib.Path:
    """Content-addressed library path (source bytes + flags); ``source``
    defaults to :data:`SOURCE` as it is at the call."""
    h = hashlib.sha256((source or SOURCE).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}.so"


def _build(flags: list[str], out: pathlib.Path,
           source: "pathlib.Path | None" = None) -> None:
    """Compile to a per-process temporary name and rename it into place
    (an atomic replace: another process's file is whole too)."""
    source = source or SOURCE
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_BASE_FLAGS, *flags, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exited {proc.returncode} building "
                               f"{source.name}: {proc.stderr.strip()}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.dir_new.argtypes = [c.c_int64]
    lib.dir_new.restype = c.c_void_p
    lib.dir_free.argtypes = [c.c_void_p]
    lib.dir_free.restype = None
    lib.dir_size.argtypes = [c.c_void_p]
    lib.dir_size.restype = c.c_int64
    lib.dir_free_count.argtypes = [c.c_void_p]
    lib.dir_free_count.restype = c.c_int64
    lib.dir_resolve_batch.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_int64), c.c_int64,
        c.POINTER(c.c_int32)]
    lib.dir_resolve_batch.restype = c.c_int64
    lib.dir_lookup.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.dir_lookup.restype = c.c_int32
    lib.dir_remove_slots.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                                     c.c_int64]
    lib.dir_remove_slots.restype = c.c_int64
    lib.dir_add_slots.argtypes = [c.c_void_p, c.c_int32, c.c_int32]
    lib.dir_add_slots.restype = None
    lib.dir_insert.argtypes = [c.c_void_p, c.c_char_p, c.c_int64, c.c_int32]
    lib.dir_insert.restype = c.c_int32
    lib.dir_set_free.argtypes = [c.c_void_p, c.POINTER(c.c_int32), c.c_int64]
    lib.dir_set_free.restype = None
    lib.dir_arena_bytes.argtypes = [c.c_void_p]
    lib.dir_arena_bytes.restype = c.c_int64
    lib.dir_dump.argtypes = [c.c_void_p, c.c_char_p, c.POINTER(c.c_int64),
                             c.POINTER(c.c_int32)]
    lib.dir_dump.restype = c.c_int64
    # 64-bit FNV-1a key fingerprints (the fingerprint store's host hash),
    # over a wire.KeyBlob's bytes and offsets.
    lib.dir_fp64_batch.argtypes = [c.c_char_p, c.POINTER(c.c_int64),
                                   c.c_int64, c.POINTER(c.c_uint32)]
    lib.dir_fp64_batch.restype = c.c_int64
    # The mesh store's key → shard routing (crc32 % n_shards) and its fused
    # route-and-resolve over one directory a shard, over a KeyBlob.
    lib.dir_route_batch.argtypes = [c.c_char_p, c.POINTER(c.c_int64),
                                    c.c_int64, c.c_int32,
                                    c.POINTER(c.c_int32)]
    lib.dir_route_batch.restype = None
    lib.dir_resolve_sharded_batch.argtypes = [
        c.c_char_p, c.POINTER(c.c_int64), c.c_int64, c.POINTER(c.c_void_p),
        c.c_int32, c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
    lib.dir_resolve_sharded_batch.restype = c.c_int64
    try:
        lib.dir_resolve_pylist.argtypes = [c.c_void_p, c.py_object,
                                           c.POINTER(c.c_int32)]
        lib.dir_resolve_pylist.restype = c.c_int64
        lib.dir_fp64_pylist.argtypes = [c.py_object, c.POINTER(c.c_uint32)]
        lib.dir_fp64_pylist.restype = c.c_int64
        lib.dir_route_pylist.argtypes = [c.py_object, c.c_int32,
                                         c.POINTER(c.c_int32)]
        lib.dir_route_pylist.restype = c.c_int64
        lib.dir_resolve_sharded_pylist.argtypes = [
            c.py_object, c.POINTER(c.c_void_p), c.c_int32,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
        lib.dir_resolve_sharded_pylist.restype = c.c_int64
        lib.has_pylist = True
    except AttributeError:  # built without Python.h
        lib.has_pylist = False
    return lib


def load_directory_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native directory; ``None`` on any
    failure — callers must fall back to the Python implementation."""
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if _TRIED:
            return _LIB
        return _load_locked()


def _load_locked() -> ctypes.CDLL | None:
    # _TRIED is published last: the unlocked fast path reads it before
    # taking the lock.
    global _LIB, _TRIED
    try:
        if os.environ.get("DRL_TPU_NO_NATIVE"):
            return None
        errors = []
        # The CPython-API build first; the plain C ABI if that fails.
        py = _python_flags()
        for flags in ([py] if py else []) + [[]]:
            try:
                out = _lib_path(flags)
                if not out.exists():
                    _build(flags, out)
                loader = ctypes.PyDLL if flags else ctypes.CDLL
                _LIB = _bind(loader(str(out)))
                return _LIB
            except Exception as exc:  # next flag set, then the fallback
                errors.append(exc)
        logging.getLogger(__name__).warning(
            "native key directory unavailable (%r); falling back to the "
            "Python directory", errors[-1])
        return None
    finally:
        _TRIED = True


# -- the serving front-end (native/frontend.cc) -----------------------------

#: Loaded front-end libraries by source path (the tests point
#: :data:`FRONTEND_SOURCE` elsewhere to exercise a failed build).
_FE_LIBS: dict[str, ctypes.CDLL] = {}


def frontend_lib_path() -> pathlib.Path:
    """The content-hashed path the front-end builds to."""
    return _lib_path([], FRONTEND_SOURCE, "libfrontend")


def load_frontend_lib() -> ctypes.CDLL:
    """Load the serving front-end, building it first if its content-hashed
    file is missing. Raises ``RuntimeError`` carrying ``g++``'s stderr when
    it cannot build; never returns ``None``."""
    key = str(FRONTEND_SOURCE)
    lib = _FE_LIBS.get(key)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _FE_LIBS.get(key)
        if lib is None:
            out = frontend_lib_path()
            if not out.exists():
                _build([], out, FRONTEND_SOURCE)
            lib = _FE_LIBS[key] = _bind_frontend(ctypes.CDLL(str(out)))
    return lib


def _bind_frontend(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Bind the front-end's whole ABI (every ``fe_*`` export)."""
    c = ctypes
    vp, i, ll, d = c.c_void_p, c.c_int, c.c_longlong, c.c_double
    p_i32, p_u8 = c.POINTER(c.c_int32), c.POINTER(c.c_uint8)
    p_u32, p_u64 = c.POINTER(c.c_uint32), c.POINTER(c.c_uint64)
    p_d, p_ll = c.POINTER(c.c_double), c.POINTER(c.c_longlong)
    sigs = {
        "fe_start": ([c.c_char_p, i, i, i, i], vp),
        "fe_start_sharded": ([c.c_char_p, i, i, i, i, i, i], vp),
        "fe_start_sharded2": ([c.c_char_p, i, i, i, i, i, i, i], vp),
        "fe_shard_count": ([vp], i),
        "fe_shard": ([vp, i], vp),
        "fe_port": ([vp], i),
        "fe_wait": ([vp, i], i),
        "fe_batch_id": ([vp], ll),
        "fe_batch_n": ([vp], i),
        "fe_batch_key_bytes": ([vp], ll),
        "fe_batch_copy": ([vp, c.c_char_p, p_i32, p_i32, p_u8, p_u32,
                           p_u64, p_d, p_d], None),
        "fe_batch_traced_n": ([vp], i),
        "fe_batch_traces": ([vp, p_u64, p_u64, p_u64, p_u8], None),
        "fe_trace_harvest": ([vp, p_u64, i], i),
        "fe_complete": ([vp, ll, p_u8, p_d], None),
        "fe_fail": ([vp, ll, c.c_char_p], None),
        "fe_has_row_skip": ([], i),
        "fe_pt_conn": ([vp], ll),
        "fe_pt_len": ([vp], i),
        "fe_pt_copy": ([vp, c.c_char_p], None),
        "fe_send": ([vp, c.c_uint64, c.c_char_p, i], None),
        "fe_set_authed": ([vp, c.c_uint64, i], None),
        "fe_close_conn": ([vp, c.c_uint64], None),
        "fe_counts": ([vp, p_ll, p_ll, p_ll], None),
        "fe_hist": ([vp, p_u64], ll),
        "fe_hist_reset": ([vp], None),
        "fe_stage_hist": ([vp, i, p_u64, p_d], ll),
        "fe_stop": ([vp], None),
        "fe_free": ([vp], None),
        "fe_loadgen": ([c.c_char_p, i, i, i, i, i, d, d, i, p_d, p_ll,
                        p_ll], i),
        "fe_lg_bulk": ([c.c_char_p, i, i, i, i, i, i, d, d, p_d, p_ll,
                        p_ll, p_ll], i),
        "fe_lg_bulk_uring": ([c.c_char_p, i, i, i, i, i, i, d, d, p_d,
                              p_ll, p_ll, p_ll], i),
        "fe_t0_configure": ([vp, i, d, d, d, i, i], i),
        "fe_t0_harvest": ([vp, c.c_char_p, i, p_i32, p_d, p_d, p_d, i], i),
        "fe_t0_ack": ([vp, c.c_char_p, p_i32, p_d, p_d, p_d, i], None),
        "fe_t0_counts": ([vp, p_ll], None),
        "fe_t0_retire": ([vp, d, d, c.c_char_p, i, p_i32, p_d, i], i),
        "fe_t0_eps": ([vp, p_d, i], i),
        "fe_bulk_configure": ([vp, i, i, i], i),
        "fe_bulk_id": ([vp], ll),
        "fe_bulk_meta": ([vp, p_u64, p_d], None),
        "fe_bulk_ptrs": ([vp, p_u64], None),
        "fe_bulk_complete": ([vp, ll, p_u8, p_d], None),
        "fe_bulk_discard": ([vp, ll], None),
        "fe_bulk_fail": ([vp, ll, c.c_char_p], None),
        "fe_bulk_counts": ([vp, p_ll], None),
        "fe_hot_harvest": ([vp, c.c_char_p, i, p_i32, p_d, i], i),
        "fe_uring_available": ([], i),
        "fe_uring_probe": ([c.c_char_p, i], i),
        "fe_uring_shards": ([vp], i),
        "fe_uring_reason": ([vp, i, c.c_char_p, i], i),
        "fe_uring_counts": ([vp, p_ll], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
