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
  ``acquire_scan_compact_packed``; ``acquire_scan_compact_fused`` (the
  same kernel, in whole-batch pieces) replaces
  ``kernels.acquire_scan_compact_fused``;
- ``acquire_scan_packed24`` (``csrc/acquire.cu``, the scan's 3-byte
  operand) replaces ``kernels.acquire_scan_packed24``;
- ``acquire_batch`` (``csrc/acquire.cu``, the scan at K = 1 over separate
  arrays) replaces ``kernels.acquire_batch``;
- ``sync_counters`` (``csrc/counter.cu``) replaces
  ``kernels.sync_batch_packed``;
- ``sweep_counters`` (``csrc/counter.cu``) replaces
  ``kernels.sweep_counters``;
- ``window_packed`` (``csrc/window.cu``) replaces
  ``kernels.window_acquire_batch_packed``;
- ``window_grouped`` (``csrc/window.cu``) replaces
  ``kernels.window_acquire_batch_packed_grouped``;
- ``window_scan_packed`` (``csrc/window.cu``) replaces
  ``kernels.window_acquire_scan_fused_packed``,
  ``window_acquire_scan_fused_bits``, ``window_acquire_scan`` and
  ``window_acquire_scan_compact``;
- ``sweep_windows`` (``csrc/window.cu``) replaces ``kernels.sweep_windows``;
- ``sema_packed`` (``csrc/sema.cu``) replaces ``kernels.sema_batch_packed``;
- ``sweep_semas`` (``csrc/sema.cu``) replaces ``kernels.sweep_semas``;
- ``acquire_hierarchical`` (``csrc/admission.cu``) replaces
  ``kernels.acquire_hierarchical_packed``;
- ``debit_packed`` (``csrc/admission.cu``) replaces
  ``kernels.debit_batch_packed``;
- the fingerprint directory's (``csrc/fp_directory.cu``; the JAX package's
  ``ops/fp_directory.py``): ``fp_acquire_scan`` replaces
  ``fp_acquire_batch``, ``fp_acquire_scan_fused`` and
  ``fp_acquire_scan_fused_bits``; ``fp_window_scan`` the three window
  forms; ``fp_debit`` replaces ``fp_debit_batch``, ``fp_peek``
  ``fp_peek_batch``, ``fp_sweep_expired`` and ``fp_sweep_windows`` their
  namesakes, ``fp_migrate`` ``fp_migrate_chunk`` and
  ``fp_migrate_window_chunk``; each runs ``fp_resolve_core``'s
  find-or-claim first (``resolve_kernel``). With ``n_shards`` the decisions,
  the peek and the migrate place keys in the mesh's shard regions
  (:mod:`.fp_directory`), every shard's rows in one launch;
- ``global_tier`` (``csrc/mesh.cu``) replaces the mesh's
  ``parallel/sharded_store.py`` ``global_tier_update`` with the ``lax.psum``
  before it (every two-level step, ``fp_sharded.py``'s scan too): one
  launch folds a decision's per-batch consumed totals into the global
  counter.

The bucket and window decision kernels share their machinery
(``csrc/decide.cuh``) on ``csrc/batch.cuh``, which the semaphore and
two-level admission kernels use too: a warp for up to 32 rows, else blocks
sized by the rows, one writer a slot (the admission kernels sort only the
rows of slots that repeat, for their in-kernel prefixes); the counter sync
and the debit share ``csrc/tally.cuh`` (the same warp and blocks, every SM
slot-major past 4096 rows, each slot's sum rounded once); the bucket
refill is ``csrc/bucket.cuh``'s. Each
source's library is named by the hash of the source and of every header
beside it. Every wrapper call on the card is one kernel launch; a bulk-lane
chunk's K batches (decided slot-major) run inside one cooperative launch,
as do a counter sync's and a debit's passes past 4096 rows. The
fingerprint wrappers chain their kernels on one stream and count one
launch a call: ``fp_acquire_scan`` and ``fp_window_scan`` the resolve, the
bucket or window scan over the resolved slots and (for the f32 result) the
resolve flags folded into row 0; ``fp_debit`` the resolve, the debit and
the unresolved rows' fix-up. The bench's
scans (``acquire_scan_packed24``, ``acquire_scan_compact_fused``) take more
rows than one launch holds: they run as consecutive launches of whole
batches, at most :data:`SCAN_MAX_ROWS` rows each, on one stream, which
decides the batches in order as one scan would.
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

from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
from distributedratelimiting.redis_tpu_torch.ops import kernels as K

__all__ = [
    "TILE",
    "SCAN_MAX_BATCH",
    "SCAN_MAX_ROWS",
    "FLUSH_MAX_BATCH",
    "NVCC_FLAGS",
    "launches",
    "reset_launches",
    "build",
    "sweep_expired",
    "acquire_packed",
    "acquire_grouped",
    "acquire_scan_packed",
    "acquire_scan_compact_fused",
    "acquire_scan_packed24",
    "acquire_batch",
    "sync_counters",
    "sweep_counters",
    "WINDOW_FLUSH_MAX_BATCH",
    "window_packed",
    "window_grouped",
    "window_scan_packed",
    "sweep_windows",
    "SEMA_MAX_BATCH",
    "TALLY_MAX_BATCH",
    "sema_packed",
    "sweep_semas",
    "acquire_hierarchical",
    "debit_packed",
    "FP_MAX_WINDOW",
    "fp_acquire_scan",
    "fp_window_scan",
    "fp_debit",
    "fp_peek",
    "fp_sweep_expired",
    "fp_sweep_windows",
    "fp_migrate",
    "global_tier",
]

#: Slots per expired-count tile, as the TPU kernel's (256 rows × 128 lanes).
TILE = 32768
#: Rows of one scan batch: the bench's B (8192); a card store's bulk lane
#: takes ``max_batch <= FLUSH_MAX_BATCH``.
SCAN_MAX_BATCH = 8192
#: Rows of one scan launch, K × B: the store's largest chunk (32 × 4096);
#: the scan kernel sizes its long-slot multisplit by it.
SCAN_MAX_ROWS = 32 * 4096
#: Rows of one flush (a warp up to 32 rows, blocks sized by the rows up to
#: 4096): a card store's ``max_batch`` at most, and the bulk lane's
#: one-batch chunks.
FLUSH_MAX_BATCH = 4096
# The scan's operand formats (csrc/decide.cuh's kOpI32, kOpFused5,
# kOpSlots24).
_OP_I32, _OP_FUSED5, _OP_SLOTS24 = 0, 1, 2
#: Rows of one window flush.
WINDOW_FLUSH_MAX_BATCH = 4096
#: Rows of one semaphore batch or two-level admission batch: one warp up to
#: 32 rows, else blocks sized by the rows (at most 1024 threads × 4 rows;
#: above 256 rows up to 64 of them).
SEMA_MAX_BATCH = 4096
#: Rows of one counter sync or debit: the C interface's int32 B (the exact
#: sums of ``csrc/tally.cuh`` hold fewer than 2^31 rows; past 4096 rows its
#: scratch takes about 50 B a row).
TALLY_MAX_BATCH = 2**31 - 1

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

#: ``-fmad=false``: no contraction of ``a + b * c`` into a fused
#: multiply-add, which would round differently from the plain version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_SOURCES = {"sweep": "sweep.cu", "acquire": "acquire.cu",
            "counter": "counter.cu", "window": "window.cu",
            "sema": "sema.cu", "admission": "admission.cu",
            "fp_directory": "fp_directory.cu", "mesh": "mesh.cu"}

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
                             _F32, _F32, _P, _P, _P, _P),
        "drl_acquire_batch": (_P, _P, _P, _I32, _P, _P, _P, _I32, _I32,
                              _I32, _F32, _F32, _P, _P, _P),
        "drl_scan_scratch_bytes": (_I32, _I32),
    },
    "counter": {
        "drl_sync_counters": (_P, _P, _P, _P, _I64, _P, _I32, _F32, _P, _P,
                              _P, _P),
        "drl_tally_scratch_bytes": (_I64, _I32),
        "drl_tally_claim_words": (_I64, _I32),
        "drl_sweep_counters": (_P, _P, _P, _P, _I64, _I32, _I64, _P),
    },
    "window": {
        "drl_window_packed": (_P, _P, _P, _P, _I32, _P, _I32, _F32, _I32,
                              _I32, _P, _P),
        "drl_window_grouped": (_P, _P, _P, _P, _I32, _P, _I32, _F32, _I32,
                               _I32, _P, _P),
        "drl_window_scan": (_P, _P, _P, _P, _I32, _P, _I32, _P, _I32, _I32,
                            _F32, _I32, _I32, _P, _P, _P, _P),
        "drl_scan_scratch_bytes": (_I32, _I32),
        "drl_sweep_windows": (_P, _P, _P, _P, _I64, _I32, _I64, _P),
    },
    "sema": {
        "drl_sema_packed": (_P, _P, _P, _I32, _P, _I32, _P, _P),
        "drl_sweep_semas": (_P, _P, _P, _P, _P, _I64, _I32, _I64, _P),
    },
    "admission": {
        "drl_acquire_hierarchical": (_P, _P, _P, _I32, _F32, _F32, _P, _P,
                                     _P, _I32, _F32, _F32, _P, _I32, _P,
                                     _P),
        "drl_debit_packed": (_P, _P, _P, _I64, _P, _I32, _F32, _F32, _P, _P,
                             _P, _P),
        "drl_tally_scratch_bytes": (_I64, _I32),
        "drl_tally_claim_words": (_I64, _I32),
    },
    "fp_directory": {
        "drl_fp_resolve": (_P, _I64, _I32, _I32, _P, _I32, _P, _I64, _P, _P,
                           _P, _P, _P),
        "drl_fp_code": (_P, _P, _I64, _I32, _P),
        "drl_fp_debit_fix": (_P, _P, _P, _I32, _P),
        "drl_fp_peek": (_P, _I64, _I32, _I32, _P, _P, _I32, _P, _P, _P, _I32,
                        _F32, _F32, _P, _P),
        "drl_fp_sweep_bucket": (_P, _P, _P, _P, _I64, _I32, _F32, _F32, _P,
                                _P),
        "drl_fp_sweep_window": (_P, _P, _P, _I64, _I32, _P, _P),
        "drl_fp_migrate": (_P, _I64, _I32, _I32, _P, _P, _I32, _I32, _P, _P,
                           _P, _P),
    },
    "mesh": {
        "drl_global_tier": (_P, _P, _P, _I32, _I32, _P, _P, _P, _P, _F32,
                            _I32, _P, _P, _P),
    },
}

#: Kernel launches per wrapper — plain ints, incremented only where a wrapper
#: launches its kernel on the card (never for the CPU's plain version).
launches = {"sweep_expired": 0, "acquire_packed": 0, "acquire_grouped": 0,
            "acquire_scan": 0, "acquire_scan24": 0, "acquire_batch": 0,
            "sync_counters": 0, "sweep_counters": 0,
            "window_packed": 0, "window_grouped": 0, "window_scan": 0,
            "sweep_windows": 0, "sema_packed": 0, "sweep_semas": 0,
            "acquire_hierarchical": 0, "debit_packed": 0,
            "fp_decide": 0, "fp_window_decide": 0, "fp_debit": 0,
            "fp_peek": 0, "fp_sweep": 0, "fp_sweep_windows": 0,
            "fp_migrate": 0, "fp_migrate_window": 0, "global_tier": 0}

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
    """Content-addressed library path: a changed source, header or flag set
    builds a new file instead of loading a stale one."""
    h = hashlib.sha256((CSRC / _SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
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
                getattr(lib, fn).restype = (ctypes.c_int64
                                            if fn.endswith("_bytes")
                                            else ctypes.c_int)
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


def _check_counters(state: K.CounterState) -> int:
    n = state.value.shape[0]
    _check(state.value, "state.value", torch.float32, (n,))
    _check(state.period, "state.period", torch.float32, (n,))
    _check(state.last_ts, "state.last_ts", torch.int32, (n,))
    _check(state.exists, "state.exists", torch.bool, (n,))
    if n >= 2**31:
        raise ValueError("tables beyond 2^31 - 1 slots are not supported")
    return n


def _on_cpu(state) -> bool:
    """True for a CPU table (the plain version runs); False for a CUDA one
    (the kernel runs); anything else raises."""
    dev = state[0].device
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {dev}")


def _tile_counts(mask: torch.Tensor) -> torch.Tensor:
    """Expired count per :data:`TILE` slots of a CPU mask, as int32."""
    n = mask.shape[0]
    t = -(-n // TILE)
    padded = torch.zeros(t * TILE, dtype=torch.int32)
    padded[:n] = mask
    return padded.view(t, TILE).sum(1, dtype=torch.int32)


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
        return mask, _tile_counts(mask)
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


def _check_scan_size(name: str, k: int, b: int) -> None:
    if b > SCAN_MAX_BATCH:
        raise ValueError(f"{name}: a batch holds at most {SCAN_MAX_BATCH} "
                         f"rows, got {b}")
    if k * b > SCAN_MAX_ROWS:
        raise ValueError(f"{name}: a launch holds at most {SCAN_MAX_ROWS} "
                         f"rows (K x B), got {k} x {b}")


def _scan_buffers(lib: ctypes.CDLL, dev, k: int, b: int,
                  with_remaining: bool):
    """The scan's result tensor and its scratch (the hash set, the sort's
    buffers and the segment table, ``drl_scan_scratch_bytes(K, B)`` bytes),
    allocated here: the kernel allocates nothing."""
    if with_remaining:
        out = torch.empty((k, 2, b), dtype=torch.float32, device=dev)
    else:
        # The kernel stores and ORs grants as whole 4-byte words.
        n_bytes = k * (b // 8)
        out = torch.empty((-(-n_bytes // 4) * 4,), dtype=torch.uint8,
                          device=dev)[:n_bytes].view(k, b // 8)
    scratch = torch.empty((int(lib.drl_scan_scratch_bytes(k, b)),),
                          dtype=torch.uint8, device=dev)
    return out, scratch


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
    B/8]`` (``B % 8 == 0``). On the card: one cooperative launch for the
    whole chunk."""
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
    _check_scan_size("acquire_scan", k, b)
    lib = _lib("acquire")
    out, scratch = _scan_buffers(lib, state.tokens.device, k, b,
                                 with_remaining)
    rc = lib.drl_acquire_scan(
        state.tokens.data_ptr(), state.last_ts.data_ptr(),
        state.exists.data_ptr(), n, operand.data_ptr(),
        _OP_FUSED5 if fused else _OP_I32, nows_k.data_ptr(), k, b,
        float(capacity), float(fill_rate_per_tick),
        out.data_ptr() if with_remaining else None,
        None if with_remaining else out.data_ptr(), scratch.data_ptr(),
        _stream(state.tokens))
    _raise_on(rc, "acquire_scan")
    launches["acquire_scan"] += 1
    return out


def _pieces(k: int, b: int) -> list[tuple[int, int]]:
    """Whole-batch pieces ``[k0, k1)`` of a K x B scan, at most
    :data:`SCAN_MAX_ROWS` rows each (read when called, so that a test can
    set it small)."""
    if b > SCAN_MAX_BATCH:
        raise ValueError(f"a batch holds at most {SCAN_MAX_BATCH} rows, "
                         f"got {b}")
    step = max(1, SCAN_MAX_ROWS // max(b, 1))
    return [(k0, min(k, k0 + step)) for k0 in range(0, k, step)]


def _scan_pieces(name: str, fmt: int, width: int, plain, state, operand,
                 nows_k, capacity, fill_rate_per_tick) -> torch.Tensor:
    """A bench scan, ``operand u8[K, B, width]`` in format ``fmt``, as
    consecutive launches of whole batches (one stream: batch order kept).
    On the CPU, ``plain`` decides each piece. Returns ``out f32[K, 2, B]``
    (grants, remaining)."""
    k, b = operand.shape[:2]
    pieces = _pieces(k, b)
    if _on_cpu(state):
        outs = []
        for k0, k1 in pieces:
            _, granted, remaining = plain(state, operand[k0:k1],
                                          nows_k[k0:k1], capacity,
                                          fill_rate_per_tick)
            outs.append(torch.stack([granted.to(torch.float32), remaining],
                                    dim=1))
        return torch.cat(outs) if outs else torch.empty((0, 2, b))
    n = _check_state(state)
    _check(operand, "operand", torch.uint8, (k, b, width))
    _check(nows_k, "nows_k", torch.int32, (k,))
    lib = _lib("acquire")
    dev = state.tokens.device
    out = torch.empty((k, 2, b), dtype=torch.float32, device=dev)
    rows = max((k1 - k0 for k0, k1 in pieces), default=0)
    scratch = torch.empty((int(lib.drl_scan_scratch_bytes(rows, b)),),
                          dtype=torch.uint8, device=dev)
    stream = _stream(state.tokens)
    for k0, k1 in pieces:
        rc = lib.drl_acquire_scan(
            state.tokens.data_ptr(), state.last_ts.data_ptr(),
            state.exists.data_ptr(), n, operand[k0].data_ptr(), fmt,
            nows_k[k0:].data_ptr(), k1 - k0, b, float(capacity),
            float(fill_rate_per_tick), out[k0].data_ptr(), None,
            scratch.data_ptr(), stream)
        _raise_on(rc, name)
        launches[name] += 1
    return out


def acquire_scan_compact_fused(state: K.BucketState, fused: torch.Tensor,
                               nows_k: torch.Tensor, capacity: float,
                               fill_rate_per_tick: float) -> torch.Tensor:
    """The bench's mixed-count scan: ``fused u8[K, B, 5]``
    (:func:`kernels.pack_compact5`), ``B <=`` :data:`SCAN_MAX_BATCH`, K
    batches decided in order against the table (updated in place), each at
    its tick ``nows_k i32[K]``. Returns ``out f32[K, 2, B]`` (grants,
    remaining: JAX's two results, stacked). On the card: one launch of the
    scan per piece of at most :data:`SCAN_MAX_ROWS` rows."""
    return _scan_pieces("acquire_scan", _OP_FUSED5, 5,
                        K.acquire_scan_compact_fused, state, fused, nows_k,
                        capacity, fill_rate_per_tick)


def acquire_scan_packed24(state: K.BucketState, packed: torch.Tensor,
                          nows_k: torch.Tensor, capacity: float,
                          fill_rate_per_tick: float) -> torch.Tensor:
    """The bench's headline: K batches of unit requests, ``packed u8[K, B,
    3]`` (:func:`kernels.pack_slots24`; :data:`kernels.SLOT24_PAD` or an id
    >= N is padding), as :func:`acquire_scan_compact_fused`. Returns ``out
    f32[K, 2, B]``. On the card: one launch per piece of at most
    :data:`SCAN_MAX_ROWS` rows (two for the bench's 32 x 8192)."""
    return _scan_pieces("acquire_scan24", _OP_SLOTS24, 3,
                        K.acquire_scan_packed24, state, packed, nows_k,
                        capacity, fill_rate_per_tick)


def acquire_batch(state: K.BucketState, slots: torch.Tensor,
                  counts: torch.Tensor, valid: torch.Tensor, now: int,
                  capacity: float, fill_rate_per_tick: float, *,
                  handle_duplicates: bool = True) -> torch.Tensor:
    """One batch from separate operands against the table (updated in
    place): ``slots i32[B]``, ``counts i32[B]``, ``valid bool[B]``, ``B <=``
    :data:`SCAN_MAX_BATCH`, at tick ``now``, with
    :func:`kernels.acquire_batch`'s ``handle_duplicates``. Returns ``out
    f32[2, B]`` (grants, remaining). On the card: one launch."""
    b = slots.shape[0]
    if b > SCAN_MAX_BATCH:
        raise ValueError(f"acquire_batch: a batch holds at most "
                         f"{SCAN_MAX_BATCH} rows, got {b}")
    if _on_cpu(state):
        _, granted, remaining = K.acquire_batch(
            state, slots, counts, valid, now, capacity, fill_rate_per_tick,
            handle_duplicates=handle_duplicates)
        return torch.stack([granted.to(torch.float32), remaining])
    n = _check_state(state)
    _check(slots, "slots", torch.int32, (b,))
    _check(counts, "counts", torch.int32, (b,))
    _check(valid, "valid", torch.bool, (b,))
    lib = _lib("acquire")
    dev = state.tokens.device
    out = torch.empty((2, b), dtype=torch.float32, device=dev)
    scratch = torch.empty((int(lib.drl_scan_scratch_bytes(1, b)),),
                          dtype=torch.uint8, device=dev)
    rc = lib.drl_acquire_batch(
        state.tokens.data_ptr(), state.last_ts.data_ptr(),
        state.exists.data_ptr(), n, slots.data_ptr(), counts.data_ptr(),
        valid.data_ptr(), int(now), b, int(bool(handle_duplicates)),
        float(capacity), float(fill_rate_per_tick), out.data_ptr(),
        scratch.data_ptr(), _stream(state.tokens))
    _raise_on(rc, "acquire_batch")
    launches["acquire_batch"] += 1
    return out


def _tally_args(lib, dev, b: int, n: int):
    """The claim words and the scratch of a sync or debit launch of ``b``
    rows on a table of ``n`` slots: none up to 4096 rows; past it int32
    words from ``torch.zeros`` (a counter, then a word a slot or a hash
    set's entries) and the scratch from ``torch.empty``."""
    need = lib.drl_tally_claim_words(n, b)
    if need == 0:
        return None, None
    words = torch.zeros((need,), dtype=torch.int32, device=dev)
    scratch = torch.empty((lib.drl_tally_scratch_bytes(n, b),),
                          dtype=torch.uint8, device=dev)
    return words, scratch


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_tally_size(name: str, b: int) -> None:
    if b > TALLY_MAX_BATCH:
        raise ValueError(f"{name}: a launch holds at most {TALLY_MAX_BATCH} "
                         f"rows, got {b}")


def sync_counters(state: K.CounterState, packed: torch.Tensor,
                  decay_rate_per_tick: float) -> torch.Tensor:
    """One decaying-counter sync against the counter table (updated in
    place): ``packed i32[3, B]`` as :func:`kernels.sync_batch_packed` takes
    it (slots, float32 counts bitcast, tick), ``B <=``
    :data:`TALLY_MAX_BATCH`. Returns ``out f32[2, B]``: the global scores
    and the period EWMAs. On the card: one launch sized by B (a warp, blocks,
    or past 4096 rows every SM in one cooperative launch)."""
    if _on_cpu(state):
        return K.sync_batch_packed(state, packed, decay_rate_per_tick)[1]
    n = _check_counters(state)
    b = packed.shape[-1]
    _check(packed, "packed", torch.int32, (3, b))
    _check_tally_size("sync_counters", b)
    dev = state.value.device
    lib = _lib("counter")
    stream = _stream(state.value)
    words, scratch = _tally_args(lib, dev, b, n)
    out = torch.empty((2, b), dtype=torch.float32, device=dev)
    rc = lib.drl_sync_counters(
        state.value.data_ptr(), state.period.data_ptr(),
        state.last_ts.data_ptr(), state.exists.data_ptr(), n,
        packed.data_ptr(), b, float(decay_rate_per_tick), out.data_ptr(),
        _ptr(words), _ptr(scratch), stream)
    _raise_on(rc, "sync_counters")
    launches["sync_counters"] += 1
    return out


def sweep_counters(state: K.CounterState, now: int):
    """TTL sweep of the counter table (the fixed 86400 s TTL): clears
    ``state.exists`` in place for expired counters and returns ``(mask
    i8[N], tile_counts i32[T])`` with the contract of
    :func:`sweep_expired`. On the card: one launch, a thread block cluster
    a tile, which writes every tile's count (no zeroing launch)."""
    n = state.value.shape[0]
    if _on_cpu(state):
        _, expired = K.sweep_counters(state, now)
        mask = expired.to(torch.int8)
        return mask, _tile_counts(mask)
    _check_counters(state)
    dev = state.value.device
    mask = torch.empty((n,), dtype=torch.int8, device=dev)
    counts = torch.empty((-(-n // TILE),), dtype=torch.int32, device=dev)
    rc = _lib("counter").drl_sweep_counters(
        state.last_ts.data_ptr(), state.exists.data_ptr(), mask.data_ptr(),
        counts.data_ptr(), n, int(now), TILE, _stream(state.value))
    _raise_on(rc, "sweep_counters")
    launches["sweep_counters"] += 1
    return mask, counts


def _check_windows(state: K.WindowState) -> int:
    n = state.prev_count.shape[0]
    _check(state.prev_count, "state.prev_count", torch.float32, (n,))
    _check(state.curr_count, "state.curr_count", torch.float32, (n,))
    _check(state.window_idx, "state.window_idx", torch.int32, (n,))
    _check(state.exists, "state.exists", torch.bool, (n,))
    if n >= 2**31:
        raise ValueError("tables beyond 2^31 - 1 slots are not supported")
    return n


def _window_ticks(window_ticks) -> int:
    w = int(window_ticks)
    if not 1 <= w < 2**31:
        raise ValueError(f"window_ticks must lie in [1, 2^31), got {w}")
    return w


def _window_ptrs(state: K.WindowState) -> tuple:
    return (state.prev_count.data_ptr(), state.curr_count.data_ptr(),
            state.window_idx.data_ptr(), state.exists.data_ptr())


def _window_flush(name: str, state: K.WindowState, packed: torch.Tensor,
                  rows: int, limit: float, window_ticks: int,
                  interpolate: bool) -> torch.Tensor:
    """One launch of a window flush kernel: ``packed i32[rows, B]`` against
    the CUDA table (updated in place); returns ``out f32[2, B]``."""
    n = _check_windows(state)
    b = packed.shape[-1]
    _check(packed, "packed", torch.int32, (rows, b))
    if b > WINDOW_FLUSH_MAX_BATCH:
        raise ValueError(f"{name}: a window flush holds at most "
                         f"{WINDOW_FLUSH_MAX_BATCH} rows, got {b}")
    out = torch.empty((2, b), dtype=torch.float32,
                      device=state.prev_count.device)
    rc = getattr(_lib("window"), f"drl_{name}")(
        *_window_ptrs(state), n, packed.data_ptr(), b, float(limit),
        _window_ticks(window_ticks), int(bool(interpolate)), out.data_ptr(),
        _stream(state.prev_count))
    _raise_on(rc, name)
    launches[name] += 1
    return out


def window_packed(state: K.WindowState, packed: torch.Tensor, limit: float,
                  window_ticks: int, *, interpolate: bool = True
                  ) -> torch.Tensor:
    """One window flush decided against the window table (updated in
    place): ``packed i32[4, B]`` as
    :func:`kernels.window_acquire_batch_packed` takes it.
    ``interpolate=False`` is the fixed window. Returns ``out f32[2, B]``."""
    if _on_cpu(state):
        return K.window_acquire_batch_packed(
            state, packed, limit, window_ticks, interpolate=interpolate)[1]
    return _window_flush("window_packed", state, packed, 4, limit,
                         window_ticks, interpolate)


def window_grouped(state: K.WindowState, packed: torch.Tensor, limit: float,
                   window_ticks: int, *, interpolate: bool = True
                   ) -> torch.Tensor:
    """One coalesced window flush (``packed i32[5, B]``, one row per ``(key,
    count)`` group) against the window table, updated in place. Returns
    ``out f32[2, B]``: granted members per group, and remaining."""
    if _on_cpu(state):
        return K.window_acquire_batch_packed_grouped(
            state, packed, limit, window_ticks, interpolate=interpolate)[1]
    return _window_flush("window_grouped", state, packed, 5, limit,
                         window_ticks, interpolate)


def window_scan_packed(state: K.WindowState, operand: torch.Tensor,
                       nows_k: torch.Tensor, limit: float, window_ticks: int,
                       *, interpolate: bool = True,
                       with_remaining: bool = True) -> torch.Tensor:
    """The window bulk lane: K batches decided in order against the window
    table (updated in place), with the operands and results of
    :func:`acquire_scan_packed` — the fused ``u8[K, B, 5]`` or ``i32[2, K,
    B]`` operand, ``nows_k i32[K]``; ``out f32[K, 2, B]`` or, with
    ``with_remaining=False``, bit-packed grants ``u8[K, B/8]``. On the card:
    one cooperative launch for the whole chunk."""
    fused = operand.dtype == torch.uint8
    k, b = operand.shape[:2] if fused else operand.shape[1:]
    if not with_remaining and b % 8:
        raise ValueError(f"bit-packed grants need B % 8 == 0, got B = {b}")
    if _on_cpu(state):
        if fused:
            fn = (K.window_acquire_scan_fused_packed if with_remaining
                  else K.window_acquire_scan_fused_bits)
            return fn(state, operand, nows_k, limit, window_ticks,
                      interpolate=interpolate)[1]
        _, granted, remaining = K.window_acquire_scan(
            state, operand[0], operand[1], operand[0] >= 0, nows_k, limit,
            window_ticks, interpolate=interpolate)
        if not with_remaining:
            return K.pack_grant_bits(granted)
        return torch.stack([granted.to(torch.float32), remaining], dim=1)
    n = _check_windows(state)
    if fused:
        _check(operand, "operand", torch.uint8, (k, b, 5))
    else:
        _check(operand, "operand", torch.int32, (2, k, b))
    _check(nows_k, "nows_k", torch.int32, (k,))
    _check_scan_size("window_scan", k, b)
    lib = _lib("window")
    out, scratch = _scan_buffers(lib, state.prev_count.device, k, b,
                                 with_remaining)
    rc = lib.drl_window_scan(
        *_window_ptrs(state), n, operand.data_ptr(), int(fused),
        nows_k.data_ptr(), k, b, float(limit), _window_ticks(window_ticks),
        int(bool(interpolate)), out.data_ptr() if with_remaining else None,
        None if with_remaining else out.data_ptr(), scratch.data_ptr(),
        _stream(state.prev_count))
    _raise_on(rc, "window_scan")
    launches["window_scan"] += 1
    return out


def sweep_windows(state: K.WindowState, now: int, window_ticks: int):
    """TTL sweep of a window table (a slot two whole windows behind
    ``now``): clears ``state.exists`` in place for expired slots and returns
    ``(mask i8[N], tile_counts i32[T])`` with the contract of
    :func:`sweep_expired`."""
    n = state.prev_count.shape[0]
    if _on_cpu(state):
        _, expired = K.sweep_windows(state, now, window_ticks)
        mask = expired.to(torch.int8)
        return mask, _tile_counts(mask)
    _check_windows(state)
    # floor(now / W), as the plain version's bucket_math.window_index.
    idx_now = int(now) // _window_ticks(window_ticks)
    dev = state.prev_count.device
    mask = torch.empty((n,), dtype=torch.int8, device=dev)
    counts = torch.zeros((-(-n // TILE),), dtype=torch.int32, device=dev)
    rc = _lib("window").drl_sweep_windows(
        state.window_idx.data_ptr(), state.exists.data_ptr(), mask.data_ptr(),
        counts.data_ptr(), n, idx_now, TILE, _stream(state.prev_count))
    _raise_on(rc, "sweep_windows")
    launches["sweep_windows"] += 1
    return mask, counts


def _check_semas(state: K.SemaState) -> int:
    n = state.active.shape[0]
    _check(state.active, "state.active", torch.int32, (n,))
    _check(state.last_ts, "state.last_ts", torch.int32, (n,))
    _check(state.exists, "state.exists", torch.bool, (n,))
    if n >= 2**31:
        raise ValueError("tables beyond 2^31 - 1 slots are not supported")
    return n


def sema_packed(state: K.SemaState, packed: torch.Tensor) -> torch.Tensor:
    """One semaphore batch against the semaphore table (updated in place):
    ``packed i32[4, B]`` as :func:`kernels.sema_batch_packed` takes it
    (slots, signed deltas, limits, tick), ``B <=`` :data:`SEMA_MAX_BATCH`.
    Returns ``out f32[2, B]``: ok, and each row's post-op active count."""
    if _on_cpu(state):
        return K.sema_batch_packed(state, packed)[1]
    n = _check_semas(state)
    b = packed.shape[-1]
    _check(packed, "packed", torch.int32, (4, b))
    if b > SEMA_MAX_BATCH:
        raise ValueError(f"sema_packed: a batch holds at most "
                         f"{SEMA_MAX_BATCH} rows, got {b}")
    out = torch.empty((2, b), dtype=torch.float32, device=state.active.device)
    rc = _lib("sema").drl_sema_packed(
        state.active.data_ptr(), state.last_ts.data_ptr(),
        state.exists.data_ptr(), n, packed.data_ptr(), b, out.data_ptr(),
        _stream(state.active))
    _raise_on(rc, "sema_packed")
    launches["sema_packed"] += 1
    return out


def sweep_semas(state: K.SemaState, now: int):
    """Idle-slot sweep of the semaphore table (no permit held, untouched for
    86400 s): clears ``state.exists`` in place and returns ``(mask i8[N],
    tile_counts i32[T])`` with the contract of :func:`sweep_expired`."""
    n = state.active.shape[0]
    if _on_cpu(state):
        _, expired = K.sweep_semas(state, now)
        mask = expired.to(torch.int8)
        return mask, _tile_counts(mask)
    _check_semas(state)
    dev = state.active.device
    mask = torch.empty((n,), dtype=torch.int8, device=dev)
    counts = torch.zeros((-(-n // TILE),), dtype=torch.int32, device=dev)
    rc = _lib("sema").drl_sweep_semas(
        state.active.data_ptr(), state.last_ts.data_ptr(),
        state.exists.data_ptr(), mask.data_ptr(), counts.data_ptr(), n,
        int(now), TILE, _stream(state.active))
    _raise_on(rc, "sweep_semas")
    launches["sweep_semas"] += 1
    return mask, counts


def acquire_hierarchical(child: K.BucketState, parent: K.BucketState,
                         packed: torch.Tensor, child_capacity: float,
                         child_rate_per_tick: float, parent_capacity: float,
                         parent_rate_per_tick: float) -> torch.Tensor:
    """Two-level (tenant → key) admission against two bucket tables (both
    updated in place): ``packed i32[4, B]`` as
    :func:`kernels.acquire_hierarchical_packed` takes it (child slots,
    costs, tick, parent slots), ``B <=`` :data:`SEMA_MAX_BATCH`. Returns
    ``out f32[2, B]``: granted, and ``min(child, parent)`` remaining."""
    if _on_cpu(child):
        if not _on_cpu(parent):
            raise ValueError("child and parent tables lie on different "
                             "devices")
        return K.acquire_hierarchical_packed(
            child, parent, packed, child_capacity, child_rate_per_tick,
            parent_capacity, parent_rate_per_tick)[2]
    n_c = _check_state(child)
    n_p = _check_state(parent)
    if parent.tokens.device != child.tokens.device:
        raise ValueError("child and parent tables lie on different devices")
    if parent.tokens.data_ptr() == child.tokens.data_ptr():
        raise ValueError("child and parent must be distinct tables")
    b = packed.shape[-1]
    _check(packed, "packed", torch.int32, (4, b))
    if b > SEMA_MAX_BATCH:
        raise ValueError(f"acquire_hierarchical: a batch holds at most "
                         f"{SEMA_MAX_BATCH} rows, got {b}")
    out = torch.empty((2, b), dtype=torch.float32, device=child.tokens.device)
    rc = _lib("admission").drl_acquire_hierarchical(
        child.tokens.data_ptr(), child.last_ts.data_ptr(),
        child.exists.data_ptr(), n_c, float(child_capacity),
        float(child_rate_per_tick), parent.tokens.data_ptr(),
        parent.last_ts.data_ptr(), parent.exists.data_ptr(), n_p,
        float(parent_capacity), float(parent_rate_per_tick),
        packed.data_ptr(), b, out.data_ptr(), _stream(child.tokens))
    _raise_on(rc, "acquire_hierarchical")
    launches["acquire_hierarchical"] += 1
    return out


def debit_packed(state: K.BucketState, packed: torch.Tensor,
                 capacity: float, fill_rate_per_tick: float) -> torch.Tensor:
    """The saturating bulk debit against the bucket table (updated in
    place), all rows in one call: ``packed i32[4, B]`` — slots, float32
    amounts bitcast, tick, and the host's float32 same-slot prefix bitcast
    (:func:`bucket_math.duplicate_prefix_float`); the plain version also
    takes JAX's ``i32[3, B]``. ``B <=`` :data:`TALLY_MAX_BATCH`. Returns
    ``out f32[2, B]``: remaining and shortfall. On the card: one launch
    sized by B, as :func:`sync_counters`."""
    if _on_cpu(state):
        return K.debit_batch_packed(state, packed, capacity,
                                    fill_rate_per_tick)[1]
    out = _debit_launch(state, packed, capacity, fill_rate_per_tick)
    launches["debit_packed"] += 1
    return out


def _debit_launch(state: K.BucketState, packed: torch.Tensor,
                  capacity: float, fill_rate_per_tick: float) -> torch.Tensor:
    """The debit kernel's launch on a CUDA table (uncounted)."""
    n = _check_state(state)
    b = packed.shape[-1]
    _check(packed, "packed", torch.int32, (4, b))
    _check_tally_size("debit_packed", b)
    dev = state.tokens.device
    lib = _lib("admission")
    stream = _stream(state.tokens)
    words, scratch = _tally_args(lib, dev, b, n)
    out = torch.empty((2, b), dtype=torch.float32, device=dev)
    rc = lib.drl_debit_packed(
        state.tokens.data_ptr(), state.last_ts.data_ptr(),
        state.exists.data_ptr(), n, packed.data_ptr(), b, float(capacity),
        float(fill_rate_per_tick), out.data_ptr(), _ptr(words),
        _ptr(scratch), stream)
    _raise_on(rc, "debit_packed")
    return out


# -- the fingerprint directory (csrc/fp_directory.cu) ------------------------
#: Widest probe window the kernels take (a window's empty cells are one
#: 32-bit mask).
FP_MAX_WINDOW = 32


def _check_fp(fp: torch.Tensor, n: int, probe_window: int,
              n_shards: int = 1) -> None:
    _check(fp, "fp", torch.int32, (n, 2))
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"a table of {n} slots does not split into "
                         f"{n_shards} shard regions")
    per = n // n_shards
    if not 1 <= probe_window <= min(FP_MAX_WINDOW, per):
        raise ValueError(f"probe_window must lie in [1, min({FP_MAX_WINDOW}, "
                         f"N / shards = {per})], got {probe_window}")


def _fp_resolve(fp: torch.Tensor, keys: torch.Tensor, stride: int, valid_in,
                rows: int, slots, counts, res, res_bits,
                probe_window: int, n_shards: int = 1) -> None:
    """The find-or-claim launch (uncounted): ``keys`` rows of ``stride``
    words; see ``csrc/fp_directory.cu``'s ``resolve_kernel``. The card
    bounds a row's claims by its window, not by ``rounds``: a row is
    unresolved only when its window is full."""
    rc = _lib("fp_directory").drl_fp_resolve(
        fp.data_ptr(), fp.shape[0], int(probe_window), int(n_shards),
        keys.data_ptr(), stride, _ptr(valid_in), rows, slots.data_ptr(),
        _ptr(counts), _ptr(res), _ptr(res_bits), _stream(fp))
    _raise_on(rc, "fp_resolve")


def _fp_decide(name: str, fp: torch.Tensor, n: int, fused: torch.Tensor,
               nows_k: torch.Tensor, with_remaining: bool, probe_window: int,
               scan, n_shards: int = 1):
    """The card's fingerprint decision: the resolve writes the scan's
    ``i32[2, K, B]`` operand (each row's cell, -1 for padding and
    unresolved rows, and its count) and the resolve flags; ``scan(op,
    out, bits)`` decides it against the table; the f32 result's row 0 then
    takes ``+ 2 * resolved``. Bits: ``u8[2, W]`` planes (grants from the
    scan, resolve flags from the resolve), returned as a ``u8[K, 2, B/8]``
    view. Returns ``(result, counts i32[K, B])``, the counts the operand's
    row 1."""
    k, b = fused.shape[:2]
    _check_fp(fp, n, probe_window, n_shards)
    _check(fused, "fused", torch.int32, (k, b, 3))
    _check(nows_k, "nows_k", torch.int32, (k,))
    _check_scan_size(name, k, b)
    rows = k * b
    dev = fp.device
    op = torch.empty((2, k, b), dtype=torch.int32, device=dev)
    if with_remaining:
        out = torch.empty((k, 2, b), dtype=torch.float32, device=dev)
        res = torch.empty((rows,), dtype=torch.uint8, device=dev)
        _fp_resolve(fp, fused, 3, None, rows, op[0], op[1], res, None,
                    probe_window, n_shards)
        scan(op, out, None)
        _raise_on(_lib("fp_directory").drl_fp_code(
            out.data_ptr(), res.data_ptr(), rows, b, _stream(fp)), name)
        return out, op[1]
    words = -(-rows // 32)
    planes = torch.empty((2, words * 4), dtype=torch.uint8, device=dev)
    _fp_resolve(fp, fused, 3, None, rows, op[0], op[1], None, planes[1],
                probe_window, n_shards)
    scan(op, None, planes[0])
    return (planes[:, :rows // 8].view(2, k, b // 8).permute(1, 0, 2),
            op[1])


def fp_acquire_scan(fp: torch.Tensor, state: K.BucketState,
                    fused: torch.Tensor, nows_k: torch.Tensor,
                    capacity: float, fill_rate_per_tick: float, *,
                    probe_window: int = 16, rounds: int = 4,
                    with_remaining: bool = True, n_shards: int = 1,
                    return_counts: bool = False):
    """K batches of fingerprint requests resolved (find-or-claim) and
    decided in order against the bucket table, both updated in place:
    ``fused i32[K, B, 3]`` (the bits of
    :func:`fp_directory.pack_fp12`), ``nows_k i32[K]``. Returns ``out
    f32[K, 2, B]`` (row 0 ``granted + 2 * resolved``, row 1 remaining) or,
    with ``with_remaining=False``, ``u8[K, 2, B/8]`` (grant plane, resolve
    plane; ``B % 8 == 0``). K = 1 is ``fp_acquire_batch``. ``rounds``
    bounds the plain version's claim rounds (JAX's rule); on the card a
    row's claims are bounded by its window. ``n_shards``: the table's shard
    regions (the mesh's; every shard's rows in one call). With
    ``return_counts`` it returns ``(out, counts i32[K, B])``, each row's
    count (0 on padding), for :func:`global_tier`."""
    k, b = fused.shape[:2]
    if not with_remaining and b % 8:
        raise ValueError(f"bit-packed results need B % 8 == 0, got B = {b}")
    if _on_cpu(state):
        fn = (F.fp_acquire_scan_fused if with_remaining
              else F.fp_acquire_scan_fused_bits)
        out = fn(fp, state, fused, nows_k, capacity, fill_rate_per_tick,
                 probe_window=probe_window, rounds=rounds,
                 n_shards=n_shards)[2]
        return (out, F._unpack_fp12(fused)[1]) if return_counts else out
    n = _check_state(state)
    lib = _lib("acquire")
    dev = state.tokens.device
    stream = _stream(state.tokens)

    def scan(op, out, bits):
        scratch = torch.empty((int(lib.drl_scan_scratch_bytes(k, b)),),
                              dtype=torch.uint8, device=dev)
        _raise_on(lib.drl_acquire_scan(
            state.tokens.data_ptr(), state.last_ts.data_ptr(),
            state.exists.data_ptr(), n, op.data_ptr(), _OP_I32,
            nows_k.data_ptr(), k, b, float(capacity),
            float(fill_rate_per_tick), _ptr(out), _ptr(bits),
            scratch.data_ptr(), stream), "fp_decide")

    out, counts = _fp_decide("fp_decide", fp, n, fused, nows_k,
                             with_remaining, probe_window, scan, n_shards)
    launches["fp_decide"] += 1
    return (out, counts) if return_counts else out


def fp_window_scan(fp: torch.Tensor, state: K.WindowState,
                   fused: torch.Tensor, nows_k: torch.Tensor, limit: float,
                   window_ticks: int, *, interpolate: bool = True,
                   probe_window: int = 16, rounds: int = 4,
                   with_remaining: bool = True,
                   n_shards: int = 1) -> torch.Tensor:
    """:func:`fp_acquire_scan` against a window table (sliding, or fixed
    with ``interpolate=False``), with its operands, results and shard
    regions. K = 1 is ``fp_window_acquire_batch``."""
    k, b = fused.shape[:2]
    if not with_remaining and b % 8:
        raise ValueError(f"bit-packed results need B % 8 == 0, got B = {b}")
    if _on_cpu(state):
        fn = (F.fp_window_acquire_scan_fused if with_remaining
              else F.fp_window_acquire_scan_fused_bits)
        return fn(fp, state, fused, nows_k, limit, window_ticks,
                  probe_window=probe_window, rounds=rounds,
                  interpolate=interpolate, n_shards=n_shards)[2]
    n = _check_windows(state)
    lib = _lib("window")
    dev = state.prev_count.device
    stream = _stream(state.prev_count)
    wt = _window_ticks(window_ticks)

    def scan(op, out, bits):
        scratch = torch.empty((int(lib.drl_scan_scratch_bytes(k, b)),),
                              dtype=torch.uint8, device=dev)
        _raise_on(lib.drl_window_scan(
            *_window_ptrs(state), n, op.data_ptr(), 0, nows_k.data_ptr(), k,
            b, float(limit), wt, int(bool(interpolate)), _ptr(out),
            _ptr(bits), scratch.data_ptr(), stream), "fp_window_decide")

    out, _ = _fp_decide("fp_window_decide", fp, n, fused, nows_k,
                        with_remaining, probe_window, scan, n_shards)
    launches["fp_window_decide"] += 1
    return out


def fp_debit(fp: torch.Tensor, state: K.BucketState, kpair: torch.Tensor,
             packed: torch.Tensor, capacity: float,
             fill_rate_per_tick: float, *, probe_window: int = 16,
             rounds: int = 4) -> torch.Tensor:
    """The saturating debit with in-kernel resolution (claim on miss)
    against the bucket table, both updated in place: ``kpair i32[B, 2]``
    and ``packed i32[4, B]`` — row 0 0 for a valid row and -1 for padding
    (the resolve writes each row's cell there), then :func:`debit_packed`'s
    rows 1-3 (float32 amounts, tick, and the host's float32 same-key prefix
    of earlier amounts, :func:`fp_directory.fp_prefix_float`, all bitcast).
    Returns ``out f32[2, B]`` (balance, shortfall); an unresolved valid row
    applies nothing and reads ``(0, max(amount, 0))``."""
    b = packed.shape[-1]
    if _on_cpu(state):
        amounts = packed[1].contiguous().view(torch.float32)
        return F.fp_debit_batch(fp, state, kpair, amounts, packed[0] >= 0,
                                int(packed[2, 0]), capacity,
                                fill_rate_per_tick,
                                probe_window=probe_window,
                                rounds=rounds)[2]
    n = _check_state(state)
    _check_fp(fp, n, probe_window)
    _check(kpair, "kpair", torch.int32, (b, 2))
    _check(packed, "packed", torch.int32, (4, b))
    res = torch.empty((b,), dtype=torch.uint8, device=fp.device)
    _fp_resolve(fp, kpair, 2, packed[0], b, packed[0], None, res, None,
                probe_window)
    out = _debit_launch(state, packed, capacity, fill_rate_per_tick)
    _raise_on(_lib("fp_directory").drl_fp_debit_fix(
        out.data_ptr(), res.data_ptr(), packed[1].data_ptr(), b,
        _stream(fp)), "fp_debit")
    launches["fp_debit"] += 1
    return out


def fp_peek(fp: torch.Tensor, state: K.BucketState, kpair: torch.Tensor,
            valid: torch.Tensor, now: int, capacity: float,
            fill_rate_per_tick: float, *, probe_window: int = 16,
            n_shards: int = 1) -> torch.Tensor:
    """Read-only availability ``floor(refilled)`` of each key's bucket, a
    lookup without claim (an absent key reads full; padding 0): ``kpair
    i32[B, 2]``, ``valid bool[B]``; ``n_shards`` the table's shard regions.
    Returns ``f32[B]``."""
    b = kpair.shape[0]
    if _on_cpu(state):
        return F.fp_peek_batch(fp, state, kpair, valid, now, capacity,
                               fill_rate_per_tick, probe_window=probe_window,
                               n_shards=n_shards)
    n = _check_state(state)
    _check_fp(fp, n, probe_window, n_shards)
    _check(kpair, "kpair", torch.int32, (b, 2))
    _check(valid, "valid", torch.bool, (b,))
    out = torch.empty((b,), dtype=torch.float32, device=fp.device)
    rc = _lib("fp_directory").drl_fp_peek(
        fp.data_ptr(), n, int(probe_window), int(n_shards), kpair.data_ptr(),
        valid.data_ptr(), b, state.tokens.data_ptr(),
        state.last_ts.data_ptr(), state.exists.data_ptr(), int(now),
        float(capacity), float(fill_rate_per_tick), out.data_ptr(),
        _stream(fp))
    _raise_on(rc, "fp_peek")
    launches["fp_peek"] += 1
    return out


def fp_sweep_expired(fp: torch.Tensor, state: K.BucketState, now: int,
                     capacity: float,
                     fill_rate_per_tick: float) -> torch.Tensor:
    """TTL sweep of a fingerprint bucket table (``sweep_expired``'s rule)
    that clears ``exists`` AND the cell of each expired slot, in place.
    Returns ``n_freed i32[1]``: one scalar to read back, no mask."""
    if _on_cpu(state):
        return F.fp_sweep_expired(fp, state, now, capacity,
                                  fill_rate_per_tick)
    n = _check_state(state)
    _check(fp, "fp", torch.int32, (n, 2))
    freed = torch.zeros((1,), dtype=torch.int32, device=fp.device)
    rc = _lib("fp_directory").drl_fp_sweep_bucket(
        fp.data_ptr(), state.tokens.data_ptr(), state.last_ts.data_ptr(),
        state.exists.data_ptr(), n, int(now), float(capacity),
        float(fill_rate_per_tick), freed.data_ptr(), _stream(fp))
    _raise_on(rc, "fp_sweep")
    launches["fp_sweep"] += 1
    return freed


def fp_sweep_windows(fp: torch.Tensor, state: K.WindowState, now: int,
                     window_ticks: int) -> torch.Tensor:
    """Window TTL sweep (two whole windows idle) that clears ``exists`` and
    the cell, in place. Returns ``n_freed i32[1]``."""
    if _on_cpu(state):
        return F.fp_sweep_windows(fp, state, now, window_ticks)
    n = _check_windows(state)
    _check(fp, "fp", torch.int32, (n, 2))
    # floor(now / W), as bucket_math.window_index.
    idx_now = int(now) // _window_ticks(window_ticks)
    freed = torch.zeros((1,), dtype=torch.int32, device=fp.device)
    rc = _lib("fp_directory").drl_fp_sweep_window(
        fp.data_ptr(), state.window_idx.data_ptr(), state.exists.data_ptr(),
        n, idx_now, freed.data_ptr(), _stream(fp))
    _raise_on(rc, "fp_sweep_windows")
    launches["fp_sweep_windows"] += 1
    return freed


def fp_migrate(fp: torch.Tensor, state, kpair: torch.Tensor, cols,
               valid: torch.Tensor, *, probe_window: int = 16,
               rounds: int = 4, n_shards: int = 1) -> torch.Tensor:
    """Growth and re-placement: claim a cell in the table ``(fp, state)``
    for each valid row of ``kpair i32[B, 2]`` and write its state columns
    ``cols`` (the state's fields in order: a bucket's tokens, last_ts,
    exists or a window's prev_count, curr_count, window_idx, exists) there;
    ``n_shards`` the table's shard regions. Returns ``placed bool[B]``; the
    caller retries unplaced rows."""
    b = kpair.shape[0]
    window = isinstance(state, K.WindowState)
    if _on_cpu(state):
        fn = F.fp_migrate_window_chunk if window else F.fp_migrate_chunk
        return fn(fp, state, kpair, *cols, valid, probe_window=probe_window,
                  rounds=rounds, n_shards=n_shards)[2]
    n = _check_windows(state) if window else _check_state(state)
    _check_fp(fp, n, probe_window, n_shards)
    _check(kpair, "kpair", torch.int32, (b, 2))
    _check(valid, "valid", torch.bool, (b,))
    if len(cols) != len(state):
        raise ValueError(f"fp_migrate: {len(state)} state columns, got "
                         f"{len(cols)}")
    for name, dst, col in zip(state._fields, state, cols):
        _check(col, name, dst.dtype, (b,))
    placed = torch.empty((b,), dtype=torch.bool, device=fp.device)
    arr = ctypes.c_void_p * len(cols)
    dst = arr(*(t.data_ptr() for t in state))
    src = arr(*(c.data_ptr() for c in cols))
    rc = _lib("fp_directory").drl_fp_migrate(
        fp.data_ptr(), n, int(probe_window), int(n_shards), kpair.data_ptr(),
        valid.data_ptr(), b, len(cols), dst, src, placed.data_ptr(),
        _stream(fp))
    _raise_on(rc, "fp_migrate")
    launches["fp_migrate_window" if window else "fp_migrate"] += 1
    return placed


# -- the mesh's global tier (csrc/mesh.cu) ------------------------------------
#: One done counter a stream for the global tier's last-block fold (the
#: kernel leaves it 0 after each launch, and launches on one stream follow
#: each other).
_TIER_DONE: dict = {}


def global_tier(out: torch.Tensor, counts: torch.Tensor,
                nows_k: torch.Tensor, g: K.GlobalCounter,
                decay_rate_per_tick: float,
                cadence: str = "batch") -> K.GlobalCounter:
    """The mesh's two-level global tier after one decision launch of K
    batches of R rows (every shard's rows of batch k in row k): ``out
    f32[K, 2, R]`` the decision's result (row 0's bit 0 the grant),
    ``counts i32[K, R]`` its counts (0 on padding), ``nows_k i32[K]``.
    Each batch's consumed total ``sum(count * grant)`` decays and adds into
    the counter ``g`` (updated in place): once a batch in order
    (``cadence="batch"``) or once at ``nows_k[-1]`` with the launch's total
    (``"launch"``). Returns ``g``. On the card: one launch."""
    if cadence not in ("batch", "launch"):
        raise ValueError("sync_cadence must be 'batch' or 'launch'")
    if _on_cpu(g):
        return K.global_tier(out, counts, nows_k, g, decay_rate_per_tick,
                             cadence)
    k, _, r = out.shape
    _check(out, "out", torch.float32, (k, 2, r))
    _check(counts, "counts", torch.int32, (k, r))
    _check(nows_k, "nows_k", torch.int32, (k,))
    dev = g.value.device
    for name, t, dtype in zip(g._fields, g, (torch.float32, torch.float32,
                                             torch.int32, torch.bool)):
        _check(t, f"g.{name}", dtype, ())
        if t.device != dev:
            raise ValueError("the global counter's fields lie on different "
                             "devices")
    if out.device != dev:
        raise ValueError(f"the decision lies on {out.device}, the counter on "
                         f"{dev}")
    stream = _stream(out)
    done = _TIER_DONE.get((dev, stream))
    if done is None:
        done = _TIER_DONE[(dev, stream)] = torch.zeros(
            (1,), dtype=torch.int32, device=dev)
    totals = torch.empty((k,), dtype=torch.int64, device=dev)
    rc = _lib("mesh").drl_global_tier(
        out.data_ptr(), counts.data_ptr(), nows_k.data_ptr(), k, r,
        g.value.data_ptr(), g.period.data_ptr(), g.last_ts.data_ptr(),
        g.exists.data_ptr(), float(decay_rate_per_tick),
        int(cadence == "launch"), totals.data_ptr(), done.data_ptr(), stream)
    _raise_on(rc, "global_tier")
    launches["global_tier"] += 1
    return g
