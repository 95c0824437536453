// The device-resident key directory for Hopper (sm_90a): find-or-claim on
// 64-bit key fingerprints, and the fingerprint table's own kernels.
//
// Replaces, in distributedratelimiting/redis_tpu/ops/fp_directory.py (XLA
// programs on the TPU, not Pallas):
//   fp_resolve_core (with _base_index and _window_cells)
//                       -> the group probe (fp_probe.cuh's
//                          warp_find_or_claim), the find-or-claim every
//                          entry point below runs first;
//   fp_acquire_batch, fp_acquire_scan_fused, fp_acquire_scan_fused_bits,
//   fp_window_acquire_batch, fp_window_acquire_scan_fused,
//   fp_window_acquire_scan_fused_bits
//                       -> fp_decide: decide.cuh's fingerprint decision
//                          (acquire.cu's drl_fp_acquire, window.cu's
//                          drl_fp_window): one launch that resolves and
//                          decides at K = 1, the resolve then the scan
//                          otherwise;
//   fp_debit_batch      -> fp_debit: resolve_kernel, admission.cu's
//                          debit_packed, debit_fix_kernel;
//   fp_peek_batch       -> peek_kernel;
//   fp_sweep_expired, fp_sweep_windows
//                       -> sweep_bucket_kernel, sweep_window_kernel;
//   fp_migrate_chunk, fp_migrate_window_chunk (_fp_migrate_core), and the
//   host loop of growth that drove them chunk by chunk (runtime/fp_store.py
//   _rehash, parallel/fp_sharded.py _rehash_locked)
//                       -> migrate_kernel<3> and migrate_kernel<4>: one pass
//                          over a whole old table (or a list of its rows, or
//                          a chunk of pairs).
// The Python wrappers (ops/cuda_kernels.py) chain the launches of one entry
// point on one stream; this file holds the kernels that touch only the
// table (the decision's kernels need the bucket or window rule, so they live
// in decide.cuh under acquire.cu and window.cu).
//
// The table: fp u32[N, 2], row (lo, hi), (0, 0) empty. Each row is read and
// claimed as ONE little-endian unsigned long long (lo in the low word), so a
// claim writes the whole pair at once.
//
// The resolve, per valid row with key (lo, hi) != (0, 0):
//   base = ((lo * 0x9E3779B1) ^ hi) mod (N - L + 1)     (uint32, as JAX)
//   (with S shard regions of P = N / S cells, the mesh's tables laid end
//   to end: base = (lo mod S) * P + ((lo * 0x9E3779B1) ^ hi) mod (P - L + 1),
//   each key in its shard's region as in a table of P cells; S = 1 is the
//   line above. Rows of different regions never meet, so one launch places
//   every shard's rows as JAX's per-shard programs do.)
//   pref = (lo ^ hi * 0x85EBCA6B) mod L
//   repeat: read the L cells [base, base + L) (through L2, __ldcg): a cell
//     holding the key is the row's slot; else, with no empty cell, the row
//     is unresolved (slot -1); else claim the first empty cell in the order
//     pref, pref + 1, ... (mod L) with atomicCAS(cell, 0, key): a CAS that
//     finds 0 or the key itself wins (duplicates of one new key share its
//     cell), a CAS that finds another key reads the window again.
// A lost CAS means another key filled a cell of the window, so the loop
// ends within L + 1 reads: the window bounds a row's claims, and a row is
// unresolved only when its window is full. JAX's R rounds (insert_rounds)
// bound the plain version's claims only; the card leaves no row
// unresolved that a free cell of its window could hold.
// Within a launch cells only go from empty to claimed, and every claim
// follows a full read of the window, so one key never takes two cells: if
// two rows of key X claimed cells a then b (a first), b's reader saw a
// empty, so b precedes a in X's rotation; but a's reader, earlier, saw b
// occupied, and b was empty until X's claim. A group of lanes reads a
// window, up to four cells a lane, and claims from one lane after ballots
// of all L loads: a ballot returns only when every lane holds its cells, so
// a claim follows a full read of the window, and the argument holds word
// for word. For the same reason all rows of one key in a launch share one
// outcome (its cell, or unresolved): a row that read the window full of
// other keys read every cell the key could have claimed already taken.
// Lookups never stop at an empty cell, so a sweep clearing a cell hides no
// other key. Padding rows count as resolved (JAX:
// resolved = ~valid). Which row wins a contested cell is the atomics'
// order, not JAX's last-scatter-wins: tables agree by key, not by slot,
// and under window pressure the unresolved rows may differ.
//
// Bound: bytes. A row reads its operand (12 B fused, 8 B a pair) and its
// window, L x 8 B (128 B at L = 16, one or two 128-byte lines), and writes
// its slot; a claim adds one 8-byte CAS. The decision that follows moves
// each touched slot's state once each way. No operation is a product:
// wgmma and the tensor cores do not apply. What a decision really waits on
// is latency: the window's round trip, then the CAS's, then the state's.
//
// Design. Every probe is the group probe (fp_probe.cuh): G lanes a window
// (G = L / 4 rounded up to a power of two, 4 at L = 16), each lane loading up
// to four cells at once, so a window is one round of coalesced loads and a
// warp probes 32 / G keys a step; rows of one key in a warp probe once. The
// callers give a warp 32 / G rows where they can, so a step is the probe's
// whole latency. A decision (decide.cuh) at K = 1 and B <= 4096 is ONE
// launch, a flush sized by its rows whose rows resolve their cells first,
// then decide with a same-key prefix computed on the card (lane order in a
// warp at B <= 32; above, blocks own the rows of a hash of the 64-bit key
// and sort their repeated cells' rows, batch.cuh); at K > 1 it is two, the
// resolve (resolve_kernel) into the scan's operand, then the scan's
// fingerprint form. Row 0 of the f32 result is written as grant + 2 x
// resolved in the same store, and the bits form writes both planes: there
// is no code pass. The peek is a lookup of one thread a row
// (find): no claim, so nothing to share.
//
// The migrate (growth): every live entry of the old table goes into a fresh
// table with its state. JAX reads the table back and ships chunks of 4,096
// rows, a launch and a readback each, because an XLA program has a fixed
// shape; here one launch walks the old table itself. Its rows are the old
// table's cells (a row is live where its cell is not 0, its state at the
// same index of the old columns), a list of the old table's rows (the rows
// a previous pass left unplaced), or a chunk of pairs with a valid mask
// (JAX's chunk form). Unplaced rows go to a device list by a warp-
// aggregated atomicAdd; the host reads one 4-byte count a pass.
// Bound of a whole-table pass: bytes. It reads N_old x 8 B of cells, and
// per entry (a live cell; no empty cell's state is read) its state
// (9 | 13 B), its window (L x 8 B), the CAS's 8 B and its state written
// (9 | 13 B); the new table's zeroing (torch.zeros, N_new x (17 | 21) B) is
// a separate launch, counted on its own. Design: a persistent grid (the
// resident blocks on every SM) of warps walks the source in 32-row tiles;
// a tile's cells and live rows' state are read coalesced, the empty cells
// (a table grows at 70% occupancy or below, so 30% or more are empty) stay
// out of the probe, and the warp probes its live rows with the group probe,
// eight a step at L = 16; each placed row's lane then writes its state. A
// warp step waits on two round trips (the window, then the CAS), so the
// rows a step set the pass's pace, and four cells a lane put eight rows in
// a step where one cell a lane would put two. Each entry's state lands in
// 32-byte sectors at random slots, which the bound, counting 9-13 bytes,
// does not see (chip_smoke.py's fp kernel phase prints a pass's device time
// beside its bound).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bucket.cuh"
#include "fp_probe.cuh"

namespace {

using drl_bucket::refill_or_init;
using drl_bucket::ttl_ticks;
using drl_fp::Fp;
using drl_fp::kFullMask;
using drl_fp::u64;
using drl_fp::warp_find_or_claim;

constexpr int kThreads = 256;

// A debit's unresolved valid rows applied nothing: (0, max(amount, 0)).
__global__ void __launch_bounds__(kThreads)
    debit_fix_kernel(float* __restrict__ out, const uint8_t* __restrict__ res,
                     const float* __restrict__ amounts, int32_t b) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < b;
       i += (int64_t)gridDim.x * kThreads) {
    if (!res[i]) {
      out[i] = 0.0f;
      out[b + i] = fmaxf(amounts[i], 0.0f);
    }
  }
}

// peek: kpair u32[B, 2], valid u8[B]; out[i] = floor(refilled) of the key's
// bucket (a full bucket when absent), 0 for padding. Writes nothing else.
__global__ void __launch_bounds__(kThreads)
    peek_kernel(Fp f, const uint32_t* __restrict__ kpair,
                const uint8_t* __restrict__ valid, int32_t b,
                const float* tokens, const int32_t* last_ts,
                const uint8_t* exists, int32_t now, float cap, float rate,
                float* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < b;
       i += (int64_t)gridDim.x * kThreads) {
    float v = 0.0f;
    if (valid[i]) {
      const int32_t s = drl_fp::find(f, kpair[2 * i], kpair[2 * i + 1]);
      const bool hit = s >= 0;
      const int32_t gs = hit ? s : 0;
      v = floorf(refill_or_init(tokens[gs], last_ts[gs],
                                hit ? exists[gs] : 0, now, cap, rate));
    }
    out[i] = v;
  }
}

// Bucket sweep (sweep_expired's rule, bucket.cuh's TTL): an expired slot
// (exists and idle past its TTL) loses exists AND its cell; n_freed (zeroed
// by the caller) counts them.
__global__ void __launch_bounds__(kThreads)
    sweep_bucket_kernel(u64* cells, const float* __restrict__ tokens,
                        const int32_t* __restrict__ last_ts, uint8_t* exists,
                        int64_t n, int32_t now, float cap, float rate,
                        int32_t* n_freed) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int expired = 0;
    if (i < n && exists[i]) {
      const int32_t elapsed =
          max((int32_t)((uint32_t)now - (uint32_t)last_ts[i]), 0);
      expired = elapsed >= ttl_ticks(tokens[i], cap, rate);
      if (expired) {
        exists[i] = 0;
        cells[i] = 0ull;
      }
    }
    const int count = __syncthreads_count(expired);
    if (threadIdx.x == 0 && count > 0) atomicAdd(n_freed, count);
  }
}

// Window sweep: idle two whole windows ((int32)(idx_now - idx) >= 2,
// wrapping) loses exists and its cell.
__global__ void __launch_bounds__(kThreads)
    sweep_window_kernel(u64* cells, const int32_t* __restrict__ idx,
                        uint8_t* exists, int64_t n, int32_t idx_now,
                        int32_t* n_freed) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int expired = 0;
    if (i < n && exists[i]) {
      expired = (int32_t)((uint32_t)idx_now - (uint32_t)idx[i]) >= 2;
      if (expired) {
        exists[i] = 0;
        cells[i] = 0ull;
      }
    }
    const int count = __syncthreads_count(expired);
    if (threadIdx.x == 0 && count > 0) atomicAdd(n_freed, count);
  }
}

// Migrate: each live source row claims a cell in the (new) table f and its
// state columns are written there. Row r of the source is index i = idx[r]
// (idx non-null) or r; its key is cells[i] (the old table's cell, live
// where not 0) or the pair kpair[i] (live where valid[i]); its column c is
// src[c][i], 4 bytes wide but the last (exists, 1 byte). placed[r] (where
// non-null) is 1 where a live row got a cell; the source index of every
// live row left unplaced (its window full) is appended to unplaced, counted
// in *n_unplaced (zeroed by the caller).
struct Cols {
  void* dst[4];
  const void* src[4];
};

struct MigrateSrc {
  const u64* cells;        // the old table, or null (pairs)
  const int32_t* idx;      // rows of cells to take, or null (all)
  const uint32_t* kpair;   // pairs u32[rows, 2], or null (old table)
  const uint8_t* valid;    // with kpair
  int64_t rows;
};

struct MigrateOut {
  uint8_t* placed;       // u8[rows] or null
  int32_t* unplaced;     // i32[rows] or null
  int32_t* n_unplaced;   // with unplaced
};

template <int kCols>
__global__ void __launch_bounds__(kThreads)
    migrate_kernel(Fp f, MigrateSrc s, Cols c, MigrateOut o) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t w = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       w * 32 < s.rows; w += warps) {
    // The tile: 32 consecutive rows, cells and live rows' state coalesced.
    const int64_t r = w * 32 + lane;
    int32_t i = 0;
    u64 key = 0;
    bool live = false;
    uint32_t v[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = 0;
    if (r < s.rows) {
      i = s.idx != nullptr ? s.idx[r] : (int32_t)r;
      if (s.cells != nullptr) {
        key = s.cells[i];
        live = key != 0ull;
      } else {
        key = ((u64)s.kpair[2 * (int64_t)i + 1] << 32) |
              s.kpair[2 * (int64_t)i];
        live = s.valid[i] != 0;
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          v[j] = j == kCols - 1
                     ? (uint32_t) static_cast<const uint8_t*>(c.src[j])[i]
                     : static_cast<const uint32_t*>(c.src[j])[i];
        }
      }
    }
    // The warp's live rows, 32 / G a step of the group probe.
    const int32_t slot = warp_find_or_claim(f, key, live);
    if (slot >= 0) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (j == kCols - 1) {
          static_cast<uint8_t*>(c.dst[j])[slot] = (uint8_t)v[j];
        } else {
          static_cast<uint32_t*>(c.dst[j])[slot] = v[j];
        }
      }
    }
    if (r < s.rows && o.placed != nullptr) o.placed[r] = slot >= 0 ? 1 : 0;
    // Unplaced rows: one atomicAdd a tile, then each writes its source index.
    const bool miss = live && slot < 0;
    const unsigned mm = __ballot_sync(kFullMask, miss);
    if (mm != 0u && o.unplaced != nullptr) {
      const int first = __ffs((int)mm) - 1;
      int32_t at = 0;
      if (lane == first) at = atomicAdd(o.n_unplaced, __popc(mm));
      at = __shfl_sync(kFullMask, at, first);
      if (miss) o.unplaced[at + __popc(mm & ((1u << lane) - 1u))] = i;
    }
  }
}

// The resident blocks of migrate_kernel<kCols> on every SM: the persistent
// grid (cached; the card does not change under a process).
template <int kCols>
int migrate_grid() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, migrate_kernel<kCols>, kThreads, 0);
    blocks = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

int grid_for(int64_t rows) {
  int64_t blocks = (rows + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  // Enough blocks to fill 132 SMs many times over; the loops cover the rest.
  if (blocks > 132 * 32) blocks = 132 * 32;
  return (int)blocks;
}

}  // namespace

// The debit's resolve over kpair u32[rows, 2], a row valid where
// valid_in[g] >= 0 (fp_probe.cuh's resolve_kernel): slots[g] the cell or
// -1, res[g] 1 where resolved or padding; slots may alias valid_in.
// shards: the table's shard regions (1: one table).
extern "C" int drl_fp_resolve(void* cells, int64_t n, int32_t L,
                              int32_t shards, const uint32_t* kpair,
                              const int32_t* valid_in, int64_t rows,
                              int32_t* slots, uint8_t* res,
                              cudaStream_t stream) {
  if (drl_fp::bad_table(n, L, shards) || valid_in == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return drl_fp::launch_resolve(drl_fp::make_fp(cells, n, L, shards), kpair,
                                2, valid_in, rows, slots, -1, nullptr, res,
                                stream);
}

extern "C" int drl_fp_debit_fix(float* out, const uint8_t* res,
                                const float* amounts, int32_t b,
                                cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  debit_fix_kernel<<<grid_for(b), kThreads, 0, stream>>>(out, res, amounts,
                                                          b);
  return (int)cudaGetLastError();
}

extern "C" int drl_fp_peek(void* cells, int64_t n, int32_t L,
                           int32_t shards, const uint32_t* kpair,
                           const uint8_t* valid,
                           int32_t b, const float* tokens,
                           const int32_t* last_ts, const uint8_t* exists,
                           int32_t now, float cap, float rate, float* out,
                           cudaStream_t stream) {
  if (drl_fp::bad_table(n, L, shards)) return (int)cudaErrorInvalidValue;
  if (b <= 0) return (int)cudaSuccess;
  const Fp f = drl_fp::make_fp(cells, n, L, shards);
  peek_kernel<<<grid_for(b), kThreads, 0, stream>>>(
      f, kpair, valid, b, tokens, last_ts, exists, now, cap, rate, out);
  return (int)cudaGetLastError();
}

extern "C" int drl_fp_sweep_bucket(void* cells, const float* tokens,
                                   const int32_t* last_ts, uint8_t* exists,
                                   int64_t n, int32_t now, float cap,
                                   float rate, int32_t* n_freed,
                                   cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  sweep_bucket_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<u64*>(cells), tokens, last_ts, exists, n, now, cap, rate,
      n_freed);
  return (int)cudaGetLastError();
}

extern "C" int drl_fp_sweep_window(void* cells, const int32_t* idx,
                                   uint8_t* exists, int64_t n,
                                   int32_t idx_now, int32_t* n_freed,
                                   cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  sweep_window_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<u64*>(cells), idx, exists, n, idx_now, n_freed);
  return (int)cudaGetLastError();
}

// One migrate pass into the (new) table cells u64[n]. The source is the old
// table old_cells (rows = its cells, or with idx the rows idx[0..rows) of
// it) or the pairs kpair u32[rows, 2] with valid u8[rows]: exactly one of
// old_cells and kpair. n_cols 3 (tokens f32, last_ts i32, exists u8) or 4
// (prev f32, curr f32, idx i32, exists u8); dst the new table's columns,
// src the source's (indexed like its cells or pairs). placed (u8[rows]) or
// unplaced (i32[rows]) with n_unplaced (i32, zeroed by the caller) may be
// null. One launch: a persistent grid of 32-row warp tiles.
extern "C" int drl_fp_migrate(void* cells, int64_t n, int32_t L,
                              int32_t shards, const void* old_cells,
                              const int32_t* idx, const uint32_t* kpair,
                              const uint8_t* valid, int64_t rows,
                              int32_t n_cols, void* const* dst,
                              const void* const* src, uint8_t* placed,
                              int32_t* unplaced, int32_t* n_unplaced,
                              cudaStream_t stream) {
  if (drl_fp::bad_table(n, L, shards) || (n_cols != 3 && n_cols != 4) ||
      (old_cells == nullptr) == (kpair == nullptr) ||
      (kpair != nullptr && (valid == nullptr || idx != nullptr)) ||
      (unplaced != nullptr && n_unplaced == nullptr) ||
      rows >= (int64_t(1) << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0) return (int)cudaSuccess;
  const Fp f = drl_fp::make_fp(cells, n, L, shards);
  Cols c{};
  for (int j = 0; j < n_cols; ++j) {
    c.dst[j] = dst[j];
    c.src[j] = src[j];
  }
  const MigrateSrc s{static_cast<const u64*>(old_cells), idx, kpair, valid,
                     rows};
  const MigrateOut o{placed, unplaced, n_unplaced};
  const int64_t tiles = (rows + 31) / 32;
  const int64_t need = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  if (n_cols == 3) {
    const int blocks = (int)(need < migrate_grid<3>() ? need
                                                      : migrate_grid<3>());
    migrate_kernel<3><<<blocks, kThreads, 0, stream>>>(f, s, c, o);
  } else {
    const int blocks = (int)(need < migrate_grid<4>() ? need
                                                      : migrate_grid<4>());
    migrate_kernel<4><<<blocks, kThreads, 0, stream>>>(f, s, c, o);
  }
  return (int)cudaGetLastError();
}
