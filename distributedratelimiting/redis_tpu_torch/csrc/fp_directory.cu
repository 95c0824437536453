// The device-resident key directory for Hopper (sm_90a): find-or-claim on
// 64-bit key fingerprints, and the fingerprint table's own kernels.
//
// Replaces, in distributedratelimiting/redis_tpu/ops/fp_directory.py (XLA
// programs on the TPU, not Pallas):
//   fp_resolve_core (with _base_index and _window_cells)
//                       -> fp_resolve (resolve_kernel), the find-or-claim
//                          every entry point below runs first;
//   fp_acquire_batch, fp_acquire_scan_fused, fp_acquire_scan_fused_bits,
//   fp_window_acquire_batch, fp_window_acquire_scan_fused,
//   fp_window_acquire_scan_fused_bits
//                       -> fp_decide: resolve_kernel, then decide.cuh's scan
//                          (the acquire or window library's drl_*_scan with
//                          the bucket or window policy), then, for the f32
//                          result, code_kernel;
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
// point on one stream; this file holds the kernels that touch the table.
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
// occupied, and b was empty until X's claim. The migrate reads a window
// with a group of lanes, up to four cells a lane, and claims from one lane
// after ballots of all L loads: a ballot returns only when every lane holds
// its cells, so its claim, too, follows a full read of the window, and the
// argument holds word for word. Lookups never stop at an empty cell, so a sweep
// clearing a cell hides no other key. Padding rows count as resolved (JAX:
// resolved = ~valid). Which row wins a contested cell is the atomics'
// order, not JAX's last-scatter-wins: tables agree by key, not by slot,
// and under window pressure the unresolved rows may differ.
//
// Bound: bytes. A row reads its operand (12 B fused, 8 B a pair) and its
// window, L x 8 B (128 B at L = 16, one or two 128-byte lines), and writes
// its slot; a claim adds one 8-byte CAS. The decision that follows moves
// each touched slot's state once each way. No operation is a product:
// wgmma and the tensor cores do not apply.
//
// Design: one thread a row, a grid-stride loop of warps over consecutive
// rows (the resolve bit plane is one __ballot_sync a 32-row word). The
// window read is a loop of L 8-byte loads (base is any cell: the window is
// 8-byte aligned, not 16): a serial probe, right for the small launches of
// a decision. The migrate probes cooperatively (below).
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
// a tile's cells and live rows' state are read coalesced, and a ballot of
// the live rows skips the empty cells (a table grows at 70% occupancy or
// below, so 30% or more are empty). The warp then probes its live rows in
// groups of G lanes (G = L / 4 rounded up to a power of two: eight rows a
// warp step at L = 16): lane s of a group loads cells s, s + G, s + 2G and
// s + 3G of the window, so a window is four coalesced G-cell requests, all
// in flight with the other groups' at once, instead of L dependent loads;
// ballots give the hit and empty masks, the group's first lane makes the
// CAS and a shuffle broadcasts it (a lost CAS reads the window again), and
// the group's lanes copy the state columns, one column a lane. A warp step
// waits on two round trips (the window, then the CAS), so the rows a step
// set the pass's pace, and four cells a lane put eight rows in a step
// where one cell a lane would put two. Each entry's state lands in 32-byte
// sectors at random slots, which the bound, counting 9-13 bytes, does not
// see (chip_smoke.py's fp kernel phase prints a pass's device time beside
// its bound).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bucket.cuh"

namespace {

using drl_bucket::refill_or_init;
using drl_bucket::ttl_ticks;

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kMix = 0x9E3779B1u;
constexpr uint32_t kPrefMix = 0x85EBCA6Bu;

using u64 = unsigned long long;

struct Fp {
  u64* cells;
  uint32_t per;     // cells of a shard region (N / shards)
  uint32_t shards;  // shard regions, >= 1
  int32_t L;        // probe window, 1..32
};

__device__ __forceinline__ uint32_t base_of(uint32_t lo, uint32_t hi,
                                            const Fp& f) {
  const uint32_t base = ((lo * kMix) ^ hi) % (f.per - (uint32_t)f.L + 1u);
  return f.shards == 1u ? base : (lo % f.shards) * f.per + base;
}

__device__ __forceinline__ uint32_t pref_of(uint32_t lo, uint32_t hi,
                                            const Fp& f) {
  return (lo ^ (hi * kPrefMix)) % (uint32_t)f.L;
}

// One read of the window: the key's position (-1 if absent) and the mask of
// empty cells.
__device__ __forceinline__ int read_window(const Fp& f, uint32_t base, u64 key,
                                           uint32_t* empty) {
  int hit = -1;
  uint32_t e = 0;
  for (int j = 0; j < f.L; ++j) {
    const u64 c = __ldcg(&f.cells[base + j]);
    if (c == key && hit < 0) hit = j;
    if (c == 0) e |= 1u << j;
  }
  *empty = e;
  return hit;
}

// The first empty cell at or after pref in the window's rotation.
__device__ __forceinline__ int first_empty(uint32_t empty, uint32_t pref,
                                           int L) {
  const uint64_t m = (uint64_t)empty;
  const uint64_t full = (L == 32) ? 0xFFFFFFFFull : ((1ull << L) - 1);
  const uint64_t rot = ((m >> pref) | (m << (L - pref))) & full;
  return (int)((pref + (uint32_t)(__ffsll((long long)rot) - 1)) %
               (uint32_t)L);
}

// Find or claim key's cell; -1 when the window is full. Each lost CAS fills
// a cell of the window, so the loop runs at most L + 1 times.
__device__ int32_t find_or_claim(const Fp& f, uint32_t lo, uint32_t hi) {
  const u64 key = ((u64)hi << 32) | lo;
  const uint32_t base = base_of(lo, hi, f);
  const uint32_t pref = pref_of(lo, hi, f);
  for (;;) {
    uint32_t empty;
    const int hit = read_window(f, base, key, &empty);
    if (hit >= 0) return (int32_t)(base + hit);
    if (empty == 0) return -1;
    const uint32_t cell = base + first_empty(empty, pref, f.L);
    const u64 old = atomicCAS(&f.cells[cell], 0ull, key);
    if (old == 0ull || old == key) return (int32_t)cell;
  }
}

// A lookup with no claim; -1 when absent.
__device__ __forceinline__ int32_t find(const Fp& f, uint32_t lo,
                                        uint32_t hi) {
  const u64 key = ((u64)hi << 32) | lo;
  const uint32_t base = base_of(lo, hi, f);
  uint32_t empty;
  const int hit = read_window(f, base, key, &empty);
  return hit >= 0 ? (int32_t)(base + hit) : -1;
}

// Rows: keys u32[rows, stride] (lo, hi[, count]). A row is valid where
// valid_in[g] >= 0 or, with valid_in null, where the count word read as
// int32 is >= 0 (pack_fp12's padding is 0xFFFFFFFF). Writes slots[g] (the
// cell, or -1 for padding and unresolved rows; slots may alias valid_in),
// counts[g] = max(count, 0) where counts is non-null, the resolve flag
// res[g] (1 resolved or padding) where res is non-null, and the same flags
// as a little-endian bit plane res_bits (rows rounded up to 32-bit words)
// where res_bits is non-null.
__global__ void __launch_bounds__(kThreads)
    resolve_kernel(Fp f, const uint32_t* __restrict__ keys, int32_t stride,
                   const int32_t* valid_in, int64_t rows, int32_t* slots,
                   int32_t* __restrict__ counts, uint8_t* __restrict__ res,
                   uint32_t* __restrict__ res_bits) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t w = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       w * 32 < rows; w += warps) {
    const int64_t g = w * 32 + lane;
    bool ok = true;
    if (g < rows) {
      const uint32_t* k = keys + g * stride;
      const uint32_t lo = k[0], hi = k[1];
      const int32_t cnt = stride > 2 ? (int32_t)k[2] : 0;
      const bool valid = valid_in != nullptr ? valid_in[g] >= 0 : cnt >= 0;
      int32_t s = -1;
      if (valid) {
        s = find_or_claim(f, lo, hi);
        ok = s >= 0;
      }
      slots[g] = s;
      if (counts != nullptr) counts[g] = cnt > 0 ? cnt : 0;
      if (res != nullptr) res[g] = ok ? 1 : 0;
    }
    const unsigned word = __ballot_sync(kFullMask, g < rows && ok);
    if (res_bits != nullptr && lane == 0) res_bits[w] = word;
  }
}

// The f32 decision result's row 0 becomes granted + 2 * resolved.
__global__ void __launch_bounds__(kThreads)
    code_kernel(float* __restrict__ out, const uint8_t* __restrict__ res,
                int64_t rows, int32_t b) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x; g < rows;
       g += stride) {
    if (res[g]) {
      const int64_t k = g / b;
      const int64_t o = k * 2 * b + (g - k * b);
      out[o] = __fadd_rn(out[o], 2.0f);
    }
  }
}

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
      const int32_t s = find(f, kpair[2 * i], kpair[2 * i + 1]);
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

// Cells a lane reads of a window: a group of G lanes covers L <= 4 G cells.
constexpr int kMaxCells = 4;

template <int kCols>
__global__ void __launch_bounds__(kThreads)
    migrate_kernel(Fp f, MigrateSrc s, Cols c, MigrateOut o, int group) {
  const int lane = threadIdx.x & 31;
  const int grp = lane / group, sub = lane - grp * group;
  const int lead = grp * group;
  const int groups = 32 / group;
  const unsigned gmask =
      group == 32 ? kFullMask : ((1u << group) - 1u) << lead;
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
      } else if (o.placed != nullptr) {
        o.placed[r] = 0;
      }
    }
    unsigned todo = __ballot_sync(kFullMask, live);
    while (todo != 0u) {  // warp-uniform
      // Group g takes the g-th live row left; up to `groups` rows a step.
      unsigned t = todo;
      for (int k = 0; k < grp && t != 0u; ++k) t &= t - 1u;
      const bool act = t != 0u;
      const int src = act ? __ffs((int)t) - 1 : lane;
      for (int k = 0; k < groups && todo != 0u; ++k) todo &= todo - 1u;
      const u64 k64 = __shfl_sync(kFullMask, key, src);
      const int32_t si = __shfl_sync(kFullMask, i, src);
      const uint32_t lo = (uint32_t)k64, hi = (uint32_t)(k64 >> 32);
      const uint32_t base = base_of(lo, hi, f);
      const uint32_t pref = pref_of(lo, hi, f);
      int32_t slot = -1;
      bool pend = act;
      while (__any_sync(kFullMask, pend)) {
        // Lane sub reads cells sub, sub + G, ... (at most four) of the
        // window, all loads in flight at once; the ballots return once
        // every lane of the group holds its cells: the whole window is read.
        u64 cell[kMaxCells];
#pragma unroll
        for (int q = 0; q < kMaxCells; ++q) {
          const int j = sub + q * group;
          cell[q] = pend && j < f.L ? __ldcg(&f.cells[base + j]) : 0ull;
        }
        uint32_t h = 0u, e = 0u;
#pragma unroll
        for (int q = 0; q < kMaxCells; ++q) {
          const bool in = pend && sub + q * group < f.L;
          const unsigned hit = __ballot_sync(kFullMask, in && cell[q] == k64);
          const unsigned emp =
              __ballot_sync(kFullMask, in && cell[q] == 0ull);
          h |= ((hit & gmask) >> lead) << (q * group);
          e |= ((emp & gmask) >> lead) << (q * group);
        }
        uint32_t target = 0;
        if (pend) {
          if (h != 0u) {
            slot = (int32_t)(base + (uint32_t)(__ffs((int)h) - 1));
            pend = false;
          } else if (e == 0u) {
            pend = false;  // the window is full: unplaced
          } else {
            target = base + (uint32_t)first_empty(e, pref, f.L);
          }
        }
        u64 old = 0ull;
        if (pend && sub == 0) old = atomicCAS(&f.cells[target], 0ull, k64);
        old = __shfl_sync(kFullMask, old, lead);
        if (pend && (old == 0ull || old == k64)) {
          slot = (int32_t)target;
          pend = false;
        }
      }
      // The state: the group's lanes copy the columns, one a lane (a lane
      // takes several where the group has fewer lanes than columns).
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const uint32_t val = __shfl_sync(kFullMask, v[j], src);
        if (slot >= 0 && j % group == sub) {
          if (j == kCols - 1) {
            static_cast<uint8_t*>(c.dst[j])[slot] = (uint8_t)val;
          } else {
            static_cast<uint32_t*>(c.dst[j])[slot] = val;
          }
        }
      }
      if (act && sub == 0 && o.placed != nullptr) {
        o.placed[w * 32 + src] = slot >= 0 ? 1 : 0;
      }
      // Unplaced rows: one atomicAdd a warp step, then each group's first
      // lane writes its row's source index.
      const bool miss = act && sub == 0 && slot < 0;
      const unsigned mm = __ballot_sync(kFullMask, miss);
      if (mm != 0u && o.unplaced != nullptr) {
        const int first = __ffs((int)mm) - 1;
        int32_t at = 0;
        if (lane == first) at = atomicAdd(o.n_unplaced, __popc(mm));
        at = __shfl_sync(kFullMask, at, first);
        if (miss) o.unplaced[at + __popc(mm & ((1u << lane) - 1u))] = si;
      }
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

bool bad_table(int64_t n, int32_t L, int32_t shards) {
  return L < 1 || L > 32 || shards < 1 || n % shards != 0 ||
         n / shards < L || n >= (int64_t(1) << 31);
}

Fp make_fp(void* cells, int64_t n, int32_t L, int32_t shards) {
  return Fp{static_cast<u64*>(cells), (uint32_t)(n / shards),
            (uint32_t)shards, L};
}

}  // namespace

// keys u32[rows, stride] (stride 2: pairs, validity from valid_in; stride 3:
// pack_fp12 rows); see resolve_kernel for the outputs. shards: the table's
// shard regions (1: one table).
extern "C" int drl_fp_resolve(void* cells, int64_t n, int32_t L,
                              int32_t shards, const uint32_t* keys,
                              int32_t stride,
                              const int32_t* valid_in, int64_t rows,
                              int32_t* slots, int32_t* counts, uint8_t* res,
                              uint32_t* res_bits, cudaStream_t stream) {
  if (bad_table(n, L, shards) || (stride != 2 && stride != 3) ||
      (stride == 2 && valid_in == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0) return (int)cudaSuccess;
  const Fp f = make_fp(cells, n, L, shards);
  // A warp a 32-row word: blocks cover 256 rows.
  resolve_kernel<<<grid_for(rows), kThreads, 0, stream>>>(
      f, keys, stride, valid_in, rows, slots, counts, res, res_bits);
  return (int)cudaGetLastError();
}

extern "C" int drl_fp_code(float* out, const uint8_t* res, int64_t rows,
                           int32_t b, cudaStream_t stream) {
  if (rows <= 0) return (int)cudaSuccess;
  code_kernel<<<grid_for(rows), kThreads, 0, stream>>>(out, res, rows, b);
  return (int)cudaGetLastError();
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
  if (bad_table(n, L, shards)) return (int)cudaErrorInvalidValue;
  if (b <= 0) return (int)cudaSuccess;
  const Fp f = make_fp(cells, n, L, shards);
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
  if (bad_table(n, L, shards) || (n_cols != 3 && n_cols != 4) ||
      (old_cells == nullptr) == (kpair == nullptr) ||
      (kpair != nullptr && (valid == nullptr || idx != nullptr)) ||
      (unplaced != nullptr && n_unplaced == nullptr) ||
      rows >= (int64_t(1) << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0) return (int)cudaSuccess;
  const Fp f = make_fp(cells, n, L, shards);
  Cols c{};
  for (int j = 0; j < n_cols; ++j) {
    c.dst[j] = dst[j];
    c.src[j] = src[j];
  }
  const MigrateSrc s{static_cast<const u64*>(old_cells), idx, kpair, valid,
                     rows};
  const MigrateOut o{placed, unplaced, n_unplaced};
  // Lanes a row: L / 4 rounded up to a power of two (4 at L = 16: eight
  // rows a warp step), each lane reading up to four cells.
  int group = 1;
  while (group * kMaxCells < L) group <<= 1;
  const int64_t tiles = (rows + 31) / 32;
  const int64_t need = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  if (n_cols == 3) {
    const int blocks = (int)(need < migrate_grid<3>() ? need
                                                      : migrate_grid<3>());
    migrate_kernel<3><<<blocks, kThreads, 0, stream>>>(f, s, c, o, group);
  } else {
    const int blocks = (int)(need < migrate_grid<4>() ? need
                                                      : migrate_grid<4>());
    migrate_kernel<4><<<blocks, kThreads, 0, stream>>>(f, s, c, o, group);
  }
  return (int)cudaGetLastError();
}
