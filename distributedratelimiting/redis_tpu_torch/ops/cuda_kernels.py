"""Hand-written Hopper kernels: build, ``ctypes`` binding, wrappers, counts.

The CUDA C++ sources live in ``../csrc``; each is compiled by ``nvcc`` for
``sm_90a`` into its own plain-C shared library under ``../build`` at first
use (:func:`build` starts one ``nvcc`` per source, all at once) and loaded
with ``ctypes``. Nothing is built or imported when this module is imported.

Each wrapper takes the state and operands as tensors:

- on the CPU it runs the kernel's plain PyTorch version from
  :mod:`.kernels` (the CPU tests and CPU stores use this);
- on a CUDA tensor it checks device, dtype, shape and contiguity, launches
  its kernel on the current stream, raises if the launch is refused, and
  adds one to :data:`launches` — there is no fallback from the kernel to
  the plain version.

The wrappers, their sources, and what each replaces in the JAX package:

- ``sweep_expired`` (``csrc/sweep.cu``) replaces
  ``pallas_kernels.sweep_expired_pallas``;
- ``acquire_packed`` (``csrc/acquire.cu``) replaces
  ``kernels.acquire_batch_packed``;
- ``acquire_grouped`` (``csrc/acquire.cu``) replaces
  ``kernels.acquire_batch_packed_grouped``;
- ``acquire_scan_packed`` (``csrc/acquire.cu``) replaces
  ``kernels.acquire_scan_fused_packed``, ``acquire_scan_fused_bits`` and
  ``acquire_scan_compact_packed``.

Every wrapper call on the card is one kernel launch; the bulk lane's K
batches and their duplicate prefixes run inside that one launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

from distributedratelimiting.redis_tpu_torch.ops import kernels as K

__all__ = [
    "TILE",
    "SCAN_MAX_BATCH",
    "FLUSH_MAX_BATCH",
    "NVCC_FLAGS",
    "launches",
    "reset_launches",
    "build",
    "sweep_expired",
    "acquire_packed",
    "acquire_grouped",
    "scan_sort_bits",
    "acquire_scan_packed",
]

#: Slots per expired-count tile, as the TPU kernel's (256 rows × 128 lanes).
TILE = 32768
#: Rows of one bulk-lane batch the scan kernel holds (1024 threads × 4).
SCAN_MAX_BATCH = 4096
#: Rows of one flush the flush kernels hold (8 B of shared memory a row).
FLUSH_MAX_BATCH = 29_056

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

#: ``-fmad=false``: no contraction of ``a + b * c`` into a fused
#: multiply-add, which would round differently from the plain version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_SOURCES = {"sweep": "sweep.cu", "acquire": "acquire.cu"}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_SIGNATURES = {
    "sweep": {
        "drl_sweep_expired": (_P, _P, _P, _P, _P, _I64, _I32, _F32, _F32,
                              _I64, _P),
    },
    "acquire": {
        "drl_acquire_packed": (_P, _P, _P, _I32, _P, _I32, _F32, _F32, _P,
                               _P),
        "drl_acquire_grouped": (_P, _P, _P, _I32, _P, _I32, _F32, _F32, _P,
                                _P),
        "drl_acquire_scan": (_P, _P, _P, _I32, _P, _I32, _P, _I32, _I32,
                             _I32, _F32, _F32, _P, _P, _P),
    },
}

#: Kernel launches per wrapper — plain ints, incremented only where a wrapper
#: launches its kernel on the card (never for the CPU's plain version).
launches = {"sweep_expired": 0, "acquire_packed": 0, "acquire_grouped": 0,
            "acquire_scan": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are compiled at first use")


def _lib_path(name: str) -> pathlib.Path:
    """Content-addressed library path: a changed source or flag set builds
    a new file instead of loading a stale one."""
    h = hashlib.sha256((CSRC / _SOURCES[name]).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together. Returns, per name,
    the library path, the build seconds (0.0 when it was already built)
    and ``nvcc``'s output (the ``-Xptxas -v`` register/spill report).
    Raises with the compiler's output if any build fails."""
    names = list(_SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        if path.exists():
            report[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / _SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        report[name] = {"path": str(path),
                        "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(build([name])[name]["path"])
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


def _check(t: torch.Tensor, what: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must lie on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_state(state: K.BucketState) -> int:
    n = state.tokens.shape[0]
    _check(state.tokens, "state.tokens", torch.float32, (n,))
    _check(state.last_ts, "state.last_ts", torch.int32, (n,))
    _check(state.exists, "state.exists", torch.bool, (n,))
    if n >= 2**31:
        raise ValueError("tables beyond 2^31 - 1 slots are not supported")
    return n


def _on_cpu(state: K.BucketState) -> bool:
    """True for a CPU table (the plain version runs); False for a CUDA one
    (the kernel runs); anything else raises."""
    dev = state.tokens.device.type
    if dev == "cpu":
        return True
    if dev == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {state.tokens.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def sweep_expired(state: K.BucketState, now: int, capacity: float,
                  fill_rate_per_tick: float):
    """TTL sweep over the whole table. Clears ``state.exists`` in place for
    expired slots and returns ``(mask i8[N], tile_counts i32[T])``, one
    expired count per :data:`TILE` slots, ``T = ceil(N / TILE)`` — a sweep
    that freed nothing is known from T ints, without reading the mask."""
    n = state.tokens.shape[0]
    t = -(-n // TILE)
    if _on_cpu(state):
        _, expired = K.sweep_expired(state, now, capacity,
                                     fill_rate_per_tick)
        mask = expired.to(torch.int8)
        padded = torch.zeros(t * TILE, dtype=torch.int32)
        padded[:n] = mask
        return mask, padded.view(t, TILE).sum(1, dtype=torch.int32)
    _check_state(state)
    lib = _lib("sweep")
    dev = state.tokens.device
    mask = torch.empty((n,), dtype=torch.int8, device=dev)
    counts = torch.zeros((t,), dtype=torch.int32, device=dev)
    rc = lib.drl_sweep_expired(
        state.tokens.data_ptr(), state.last_ts.data_ptr(),
        state.exists.data_ptr(), mask.data_ptr(), counts.data_ptr(), n,
        int(now), float(capacity), float(fill_rate_per_tick), TILE,
        _stream(state.tokens))
    _raise_on(rc, "sweep_expired")
    launches["sweep_expired"] += 1
    return mask, counts


def _flush(name: str, state: K.BucketState, packed: torch.Tensor,
           rows: int, capacity: float,
           fill_rate_per_tick: float) -> torch.Tensor:
    """One launch of a flush kernel: ``packed i32[rows, B]`` against the
    CUDA table (updated in place); returns ``out f32[2, B]``."""
    n = _check_state(state)
    b = packed.shape[-1]
    _check(packed, "packed", torch.int32, (rows, b))
    if b > FLUSH_MAX_BATCH:
        raise ValueError(f"{name}: a flush holds at most {FLUSH_MAX_BATCH} "
                         f"rows, got {b}")
    out = torch.empty((2, b), dtype=torch.float32, device=state.tokens.device)
    rc = getattr(_lib("acquire"), f"drl_{name}")(
        state.tokens.data_ptr(), state.last_ts.data_ptr(),
        state.exists.data_ptr(), n, packed.data_ptr(), b, float(capacity),
        float(fill_rate_per_tick), out.data_ptr(), _stream(state.tokens))
    _raise_on(rc, name)
    launches[name] += 1
    return out


def acquire_packed(state: K.BucketState, packed: torch.Tensor,
                   capacity: float, fill_rate_per_tick: float) -> torch.Tensor:
    """One flush decided against the table (updated in place): ``packed
    i32[4, B]`` as :func:`kernels.acquire_batch_packed` takes it, with the
    host's duplicate prefix in row 3. Returns ``out f32[2, B]``."""
    if _on_cpu(state):
        return K.acquire_batch_packed(state, packed, capacity,
                                      fill_rate_per_tick)[1]
    return _flush("acquire_packed", state, packed, 4, capacity,
                  fill_rate_per_tick)


def acquire_grouped(state: K.BucketState, packed: torch.Tensor,
                    capacity: float,
                    fill_rate_per_tick: float) -> torch.Tensor:
    """One coalesced flush (``packed i32[5, B]``, one row per ``(key,
    count)`` group) against the table, updated in place. Returns ``out
    f32[2, B]``: granted members per group, and remaining."""
    if _on_cpu(state):
        return K.acquire_batch_packed_grouped(state, packed, capacity,
                                              fill_rate_per_tick)[1]
    return _flush("acquire_grouped", state, packed, 5, capacity,
                  fill_rate_per_tick)


def scan_sort_bits(n_slots: int) -> int:
    """Key bits the bulk kernel's radix sort orders: every slot ``0 … N-1``
    and the padding key ``N`` (which sorts after every slot) fit, and no
    more — ``bit_length(N)``, whatever N a grown or restored table has."""
    return int(n_slots).bit_length()


def acquire_scan_packed(state: K.BucketState, operand: torch.Tensor,
                        nows_k: torch.Tensor, capacity: float,
                        fill_rate_per_tick: float, *,
                        with_remaining: bool = True) -> torch.Tensor:
    """The bulk lane: K batches decided in order against the table (updated
    in place), each with its in-batch duplicate prefix, at its own tick
    ``nows_k i32[K]``. ``operand`` is the fused ``u8[K, B, 5]`` of
    :func:`kernels.pack_compact5` (counts ≤ 255) or ``i32[2, K, B]`` (slots,
    then counts). Returns ``out f32[K, 2, B]`` (grants, remaining), or with
    ``with_remaining=False`` the grants bit-packed little-endian, ``u8[K,
    B/8]`` (``B % 8 == 0``). On the card: one launch for the whole chunk."""
    fused = operand.dtype == torch.uint8
    k, b = operand.shape[:2] if fused else operand.shape[1:]
    if not with_remaining and b % 8:
        raise ValueError(f"bit-packed grants need B % 8 == 0, got B = {b}")
    if _on_cpu(state):
        if fused:
            fn = (K.acquire_scan_fused_packed if with_remaining
                  else K.acquire_scan_fused_bits)
            return fn(state, operand, nows_k, capacity, fill_rate_per_tick)[1]
        out = K.acquire_scan_packed(state, operand[0], operand[1], nows_k,
                                    capacity, fill_rate_per_tick)[1]
        return out if with_remaining else K.pack_grant_bits(out[:, 0] > 0.5)
    n = _check_state(state)
    if fused:
        _check(operand, "operand", torch.uint8, (k, b, 5))
    else:
        _check(operand, "operand", torch.int32, (2, k, b))
    _check(nows_k, "nows_k", torch.int32, (k,))
    if b > SCAN_MAX_BATCH:
        raise ValueError(f"acquire_scan: a batch holds at most "
                         f"{SCAN_MAX_BATCH} rows, got {b}")
    dev = state.tokens.device
    if with_remaining:
        out = torch.empty((k, 2, b), dtype=torch.float32, device=dev)
    else:
        # The kernel ORs grants into whole 4-byte words of the allocation.
        n_bytes = k * (b // 8)
        out = torch.empty((-(-n_bytes // 4) * 4,), dtype=torch.uint8,
                          device=dev)[:n_bytes].view(k, b // 8)
    rc = _lib("acquire").drl_acquire_scan(
        state.tokens.data_ptr(), state.last_ts.data_ptr(),
        state.exists.data_ptr(), n, operand.data_ptr(), int(fused),
        nows_k.data_ptr(), k, b, scan_sort_bits(n), float(capacity),
        float(fill_rate_per_tick), out.data_ptr() if with_remaining else None,
        None if with_remaining else out.data_ptr(), _stream(state.tokens))
    _raise_on(rc, "acquire_scan")
    launches["acquire_scan"] += 1
    return out
