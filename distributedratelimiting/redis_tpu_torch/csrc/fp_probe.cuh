// The fingerprint table's placement and its find-or-claim, for Hopper
// (sm_90a): the device functions that every kernel touching the table
// shares (fp_directory.cu's peek, migrate and debit, and decide.cuh's
// fingerprint decision), and resolve_kernel, the find-or-claim of a list of
// rows (the debit's, and a decision's of K > 1 batches). The placement,
// the claim rule and the table's invariants are described at the top of
// fp_directory.cu.
//
// The probe is cooperative: a group of G lanes reads one key's window, G =
// L / 4 rounded up to a power of two (4 at L = 16, so a warp probes eight
// keys at once). Lane s of a group loads cells s, s + G, s + 2G and s + 3G
// of the window, so a window is four coalesced G-cell requests, all in
// flight with the other groups' at once, instead of L dependent loads;
// ballots give the hit and empty masks, the group's first lane makes the CAS
// and a shuffle broadcasts it (a lost CAS reads the window again). A ballot
// returns only when every lane of the group holds its cells, so a claim
// follows a full read of the window, as the invariants need.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace drl_fp {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kMix = 0x9E3779B1u;
constexpr uint32_t kPrefMix = 0x85EBCA6Bu;
// Cells a lane reads of a window: a group of G lanes covers L <= 4 G cells.
constexpr int kMaxCells = 4;

using u64 = unsigned long long;

struct Fp {
  u64* cells;
  uint32_t per;     // cells of a shard region (N / shards)
  uint32_t shards;  // shard regions, >= 1
  int32_t L;        // probe window, 1..32
  int32_t group;    // lanes a window: probe_group(L)
};

// Lanes a window: L / 4 rounded up to a power of two.
__host__ __device__ inline int probe_group(int L) {
  int g = 1;
  while (g * kMaxCells < L) g <<= 1;
  return g;
}

__host__ inline bool bad_table(int64_t n, int32_t L, int32_t shards) {
  return L < 1 || L > 32 || shards < 1 || n % shards != 0 ||
         n / shards < L || n >= (int64_t(1) << 31);
}

__host__ inline Fp make_fp(void* cells, int64_t n, int32_t L,
                           int32_t shards) {
  return Fp{static_cast<u64*>(cells), (uint32_t)(n / shards),
            (uint32_t)shards, L, probe_group(L)};
}

__device__ __forceinline__ uint32_t base_of(uint32_t lo, uint32_t hi,
                                            const Fp& f) {
  const uint32_t base = ((lo * kMix) ^ hi) % (f.per - (uint32_t)f.L + 1u);
  return f.shards == 1u ? base : (lo % f.shards) * f.per + base;
}

__device__ __forceinline__ uint32_t pref_of(uint32_t lo, uint32_t hi,
                                            const Fp& f) {
  return (lo ^ (hi * kPrefMix)) % (uint32_t)f.L;
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

// A lookup with no claim, by one thread; -1 when absent (the peek's: one
// row a thread, a serial read of the window).
__device__ __forceinline__ int32_t find(const Fp& f, uint32_t lo,
                                        uint32_t hi) {
  const u64 key = ((u64)hi << 32) | lo;
  const uint32_t base = base_of(lo, hi, f);
  for (int j = 0; j < f.L; ++j) {
    if (__ldcg(&f.cells[base + j]) == key) return (int32_t)(base + j);
  }
  return -1;
}

// Find or claim, for the whole warp: every lane calls it (a warp
// collective); each lane with `want` gets its key's cell, or -1 when the
// window is full; every other lane gets -1. Lanes of one key probe once (the
// lowest of them) and share its cell. Up to 32 / G keys a step, the g-th
// group taking the g-th key still pending; a step waits on two round trips
// (the window, then the CAS), so a caller gives a warp at most 32 / G keys
// where it can.
__device__ inline int32_t warp_find_or_claim(const Fp& f, u64 key, bool want) {
  const int lane = threadIdx.x & 31;
  const int group = f.group;
  const int grp = lane / group, sub = lane - grp * group;
  const int lead = grp * group;
  const int groups = 32 / group;
  const unsigned gmask =
      group == 32 ? kFullMask : ((1u << group) - 1u) << lead;
  const unsigned peers = __match_any_sync(kFullMask, want ? key : 0ull);
  const int first = __ffs((int)peers) - 1;
  int32_t mine = -1;
  unsigned todo = __ballot_sync(kFullMask, want && lane == first);
  while (todo != 0u) {  // warp-uniform
    // Lane x, pending, is this step's rank-th pending lane: group rank takes
    // it when rank < groups.
    const int rank = __popc(todo & ((1u << lane) - 1u));
    const bool taken = ((todo >> lane) & 1u) && rank < groups;
    unsigned t = todo;
    for (int k = 0; k < grp && t != 0u; ++k) t &= t - 1u;
    const bool act = t != 0u;
    const int src = act ? __ffs((int)t) - 1 : lane;
    for (int k = 0; k < groups && todo != 0u; ++k) todo &= todo - 1u;
    const u64 k64 = __shfl_sync(kFullMask, key, src);
    const uint32_t lo = (uint32_t)k64, hi = (uint32_t)(k64 >> 32);
    const uint32_t base = base_of(lo, hi, f);
    const uint32_t pref = pref_of(lo, hi, f);
    int32_t slot = -1;
    bool pend = act;
    while (__any_sync(kFullMask, pend)) {
      // Lane sub reads cells sub, sub + G, ... (at most four) of the
      // window, all loads in flight at once; the ballots return once every
      // lane of the group holds its cells: the whole window is read.
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
        const unsigned emp = __ballot_sync(kFullMask, in && cell[q] == 0ull);
        h |= ((hit & gmask) >> lead) << (q * group);
        e |= ((emp & gmask) >> lead) << (q * group);
      }
      uint32_t target = 0;
      if (pend) {
        if (h != 0u) {
          slot = (int32_t)(base + (uint32_t)(__ffs((int)h) - 1));
          pend = false;
        } else if (e == 0u) {
          pend = false;  // the window is full: unresolved
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
    // Each taken lane reads its cell from its group's first lane.
    const int32_t got =
        __shfl_sync(kFullMask, slot, (taken ? rank : 0) * group);
    if (taken) mine = got;
  }
  // The key's other lanes read its cell from its first lane.
  const int32_t cell = __shfl_sync(kFullMask, mine, first);
  return want ? cell : -1;
}

constexpr int kResolveThreads = 256;

// Find or claim every row's cell: keys u32[rows, stride] (lo, hi[, count]);
// a row is valid where valid_in[g] >= 0 or, with valid_in null, where the
// count word read as int32 is >= 0 (pack_fp12's padding is 0xFFFFFFFF).
// Writes slots[g]: the cell, -1 for padding, `unresolved` for a valid row
// whose window is full (slots may alias valid_in); counts[g] = max(count,
// 0) and res[g] (1 resolved or padding) where non-null. A warp takes 32 / G
// consecutive rows: one step of the group probe.
__global__ void __launch_bounds__(kResolveThreads)
    resolve_kernel(Fp f, const uint32_t* __restrict__ keys, int32_t stride,
                   const int32_t* valid_in, int64_t rows, int32_t* slots,
                   int32_t unresolved, int32_t* __restrict__ counts,
                   uint8_t* __restrict__ res) {
  const int lane = threadIdx.x & 31;
  const int rpw = 32 / f.group;
  const int64_t warps = (int64_t)gridDim.x * (kResolveThreads / 32);
  for (int64_t w = (int64_t)blockIdx.x * (kResolveThreads / 32) +
                   (threadIdx.x >> 5);
       w * rpw < rows; w += warps) {
    const int64_t g = w * rpw + lane;
    const bool in = lane < rpw && g < rows;
    uint32_t lo = 0, hi = 0;
    int32_t cnt = 0;
    bool valid = false;
    if (in) {
      const uint32_t* k = keys + g * stride;
      lo = k[0];
      hi = k[1];
      cnt = stride > 2 ? (int32_t)k[2] : 0;
      valid = valid_in != nullptr ? valid_in[g] >= 0 : cnt >= 0;
    }
    const int32_t s = warp_find_or_claim(f, ((u64)hi << 32) | lo, valid);
    if (in) {
      slots[g] = !valid ? -1 : s >= 0 ? s : unresolved;
      if (counts != nullptr) counts[g] = cnt > 0 ? cnt : 0;
      if (res != nullptr) res[g] = !valid || s >= 0 ? 1 : 0;
    }
  }
}

__host__ inline int launch_resolve(const Fp& f, const uint32_t* keys,
                                   int32_t stride, const int32_t* valid_in,
                                   int64_t rows, int32_t* slots,
                                   int32_t unresolved, int32_t* counts,
                                   uint8_t* res, cudaStream_t stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const int64_t per_block =
      (int64_t)(kResolveThreads / 32) * (32 / f.group);
  int64_t blocks = (rows + per_block - 1) / per_block;
  // Enough blocks to fill 132 SMs many times over; the loop covers the rest.
  if (blocks > 132 * 32) blocks = 132 * 32;
  resolve_kernel<<<(unsigned)blocks, kResolveThreads, 0, stream>>>(
      f, keys, stride, valid_in, rows, slots, unresolved, counts, res);
  return (int)cudaGetLastError();
}

}  // namespace drl_fp
