"""Loader for the native key directory (``native/directory.cc``).

The directory half of the JAX package's ``utils/native.py``. The C++
directory is host code shared by the repository; the port compiles it
where it lies and never copies or edits it. The library is built with
``g++`` at first use into the port's own (git-ignored) ``build/``
directory, never into ``native/build/``, whose binaries are committed:

- the file name carries a hash of the source and the flags, so a changed
  source builds a new file instead of loading a stale one;
- ``g++`` writes to a per-process temporary name that is then renamed into
  place, so several processes building at once each load a whole file;
- with ``Python.h`` present the build adds ``-DDRL_WITH_PYTHON``, so that
  ``dir_resolve_pylist`` reads each ``str``'s cached UTF-8 with no copy;
  the library is then loaded with ``ctypes.PyDLL``, since that call reads
  Python objects under the GIL.

Any failure (no compiler, read-only checkout) yields ``None`` and a logged
warning; callers fall back to the Python directory. ``DRL_TPU_NO_NATIVE=1``
forces the fallback. The sanitizer builds and the serving front-end's
loader are not ported.
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

__all__ = ["BUILD_DIR", "SOURCE", "load_directory_lib"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
#: The shared host source, compiled where it lies.
SOURCE = _PKG.parents[1] / "native" / "directory.cc"
BUILD_DIR = _PKG / "build"
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


def _lib_path(flags: list[str]) -> pathlib.Path:
    """Content-addressed library path (source bytes + flags)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"libdirectory-{h.hexdigest()[:12]}.so"


def _build(flags: list[str], out: pathlib.Path) -> None:
    """Compile to a per-process temporary name and rename it into place
    (an atomic replace: another process's file is whole too)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_BASE_FLAGS, *flags, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exited {proc.returncode}: "
                               f"{proc.stderr.strip()}")
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
    try:
        lib.dir_resolve_pylist.argtypes = [c.c_void_p, c.py_object,
                                           c.POINTER(c.c_int32)]
        lib.dir_resolve_pylist.restype = c.c_int64
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
