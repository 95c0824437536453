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
//   fp_migrate_chunk, fp_migrate_window_chunk (_fp_migrate_core)
//                       -> migrate_kernel<3> and migrate_kernel<4>.
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
// occupied, and b was empty until X's claim. Lookups never stop at an empty
// cell, so a sweep clearing a cell hides no other key. Padding rows count as
// resolved (JAX: resolved = ~valid). Which row wins a contested cell is the
// atomics' order, not JAX's last-scatter-wins: tables agree by key, not by
// slot, and under window pressure the unresolved rows may differ.
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
// 8-byte aligned, not 16). Simple first: a row's probe is serial in its
// thread; a warp-cooperative probe (a lane a cell) is later work.

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

// Migrate: claim a cell in the (new) table for each valid row of kpair
// u32[B, 2] and write its state columns there: column c of row i is
// src[c] + i * width[c], copied as width[c] bytes (4 or 1). placed[i] is 1
// where a valid row got a cell.
struct Cols {
  void* dst[4];
  const void* src[4];
  int32_t width[4];
};

template <int kCols>
__global__ void __launch_bounds__(kThreads)
    migrate_kernel(Fp f, const uint32_t* __restrict__ kpair,
                   const uint8_t* __restrict__ valid, int32_t b, Cols c,
                   uint8_t* __restrict__ placed) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < b;
       i += (int64_t)gridDim.x * kThreads) {
    int32_t s = -1;
    if (valid[i]) s = find_or_claim(f, kpair[2 * i], kpair[2 * i + 1]);
    if (s >= 0) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (c.width[j] == 4) {
          static_cast<uint32_t*>(c.dst[j])[s] =
              static_cast<const uint32_t*>(c.src[j])[i];
        } else {
          static_cast<uint8_t*>(c.dst[j])[s] =
              static_cast<const uint8_t*>(c.src[j])[i];
        }
      }
    }
    placed[i] = s >= 0 ? 1 : 0;
  }
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

// n_cols 3 (tokens f32, last_ts i32, exists u8) or 4 (prev f32, curr f32,
// idx i32, exists u8); dst/src the new table's and the chunk's columns.
extern "C" int drl_fp_migrate(void* cells, int64_t n, int32_t L,
                              int32_t shards, const uint32_t* kpair,
                              const uint8_t* valid,
                              int32_t b, int32_t n_cols, void* const* dst,
                              const void* const* src, uint8_t* placed,
                              cudaStream_t stream) {
  if (bad_table(n, L, shards) || (n_cols != 3 && n_cols != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b <= 0) return (int)cudaSuccess;
  const Fp f = make_fp(cells, n, L, shards);
  Cols c{};
  for (int j = 0; j < n_cols; ++j) {
    c.dst[j] = dst[j];
    c.src[j] = src[j];
    c.width[j] = j == n_cols - 1 ? 1 : 4;
  }
  if (n_cols == 3) {
    migrate_kernel<3><<<grid_for(b), kThreads, 0, stream>>>(f, kpair, valid,
                                                            b, c, placed);
  } else {
    migrate_kernel<4><<<grid_for(b), kThreads, 0, stream>>>(f, kpair, valid,
                                                            b, c, placed);
  }
  return (int)cudaGetLastError();
}
