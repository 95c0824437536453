// Same-slot prefixes inside one batch of at most 4096 rows, for the
// semaphore (sema.cu) and two-level admission (admission.cu) kernels: a
// launch costs what its rows need, not a block-wide sort of 4096 keys. The
// bucket and window flushes (decide.cuh) take the same warp and block
// partition, the hash set and peer_sum; with the host's prefix they need no
// sort, only one writer a slot.
//
// Both kernels need, per row, the int64 sum of a demand over the EARLIER
// rows of the same slot (request order), and per slot one writer. Two
// paths, chosen by the batch size B on the host:
//
//   - Warp (B <= 32: the scalar, wire and policy lanes, nearly every
//     launch). One warp, row = lane. __match_any_sync on the slot gives each
//     row its same-slot peers; lane order is request order, so a row's
//     exclusive prefix is the sum over its lower-lane peers (lane_sums: one
//     shuffle a row of the batch), and the highest lane of a peer set is the
//     slot's writer. No shared memory, no block barrier. A batch in which no
//     slot repeats (every peer set a single lane) skips the sums.
//   - Block (33 <= B <= 4096; kT threads of kIpt rows, kT x kIpt the
//     smallest configuration that holds B). One SM's load and store pipes
//     bound a block that gathers and writes 4096 scattered slots (~0.03 ms
//     on the H100 with no sort at all), so a large batch is spread over
//     several blocks, each taking the rows of its share of the slots
//     (own_rows: a hash of the slot picks the block; a padding row goes to
//     block r mod G). All rows of a slot meet in one block, so the blocks
//     need no barrier between them, and each decides its rows as one batch
//     in request order. (The two-level kernel, which must check its
//     partition, lets block 0 decide a batch whose rows all go to one
//     block: one_block.) In a block, find_repeats counts every slot's rows
//     in a hash set in shared memory (warp-aggregated: one atomic a slot a
//     warp). Where no slot repeats, every row decides at once with prefix 0
//     and writes its own slot. Otherwise each repeated slot takes a compact
//     id below the block's rows / 2, rows are sorted stably by that id (the
//     others, each alone, after them) with cub::BlockRadixSort over
//     bit_length(ids) <= 12 bits, and int64 segmented scans (Seg/SegSum,
//     below) run in that order.
//
// Both paths read the slot as the row's 32-bit key; padding rows use
// kEmptyKey (no slot is >= 2^31), so no table size sets a bit range.

#pragma once

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace drl {

constexpr uint32_t kEmptyKey = 0xFFFFFFFFu;  // no slot is >= 2^31
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Segmented int64 sums (the block paths' and the scan's block walks): a
// running sum, and the position of the segment's head (-1 on a non-head
// input element).
struct Seg {
  long long sum;
  int head;
};

struct SegSum {
  __device__ __forceinline__ Seg operator()(const Seg& a,
                                            const Seg& b) const {
    return b.head >= 0 ? b : Seg{a.sum + b.sum, a.head};
  }
};

}  // namespace drl

namespace drl_batch {

using drl::kEmptyKey;
using drl::kFullMask;

constexpr int kWarpRows = 32;

// Warp path: over lanes j < n (uniform across the warp), the int64 sums of
// v_j over the lanes of `below` and of `all`.
__device__ __forceinline__ void lane_sums(unsigned below, unsigned all,
                                          int32_t v, int n, long long& s_below,
                                          long long& s_all) {
  s_below = 0;
  s_all = 0;
  for (int j = 0; j < n; ++j) {
    const int32_t x = __shfl_sync(kFullMask, v, j);
    if ((below >> j) & 1u) s_below += x;
    if ((all >> j) & 1u) s_all += x;
  }
}

// The int64 sum of the values the lanes of `peers` left in their slots of
// the warp's buffer buf (buf[lane], then a __syncwarp): one lane reads its
// peers' values, where a warp-wide shuffle sum takes 32 shuffles.
__device__ __forceinline__ long long peer_sum(const long long* buf,
                                              unsigned peers) {
  long long s = 0;
  for (unsigned m = peers; m != 0; m &= m - 1) s += buf[__ffs(m) - 1];
  return s;
}

// Block path: the shared memory of a batch of kT x kIpt rows. The kernels
// put their own arrays after it.
template <int kT, int kIpt>
struct Block {
  static constexpr int kRows = kT * kIpt;
  // The hash set: at most one entry a row, load factor <= 1/2.
  static constexpr int kHash = 2 * kRows;
  static_assert((kRows & (kRows - 1)) == 0, "rows are a power of two");
  using Sort = cub::BlockRadixSort<uint32_t, kT, kIpt, uint16_t>;
  using Scan = cub::BlockScan<drl::Seg, kT, cub::BLOCK_SCAN_WARP_SCANS>;
  using Count = cub::BlockScan<int, kT, cub::BLOCK_SCAN_WARP_SCANS>;
  union Temp {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
    typename Count::TempStorage count;
  };
  struct Shared {
    Temp temp;
    uint32_t key[kRows];    // the sort's keys, by sorted position
    uint32_t hkey[kHash];   // an entry's slot, kEmptyKey if free
    uint32_t hval[kHash];   // its rows in the batch, then its compact id
    uint16_t sub[kRows];    // several blocks: the block's rows, in order
    int32_t n_rep;          // slots with more than one row
  };
};

// Blocks of a launch of b > 32 rows: one up to 256 rows, one per 64 rows
// above (at most 64).
inline int launch_blocks(int32_t b) {
  return b <= 256 ? 1 : (b / 64 < 64 ? (int)(b / 64) : 64);
}

// The block of G a row goes to: a hash of its slot, so that all rows of a
// slot meet in one block; a padding row (kEmptyKey) by its index.
__device__ __forceinline__ int block_of(uint32_t key, int r) {
  const unsigned g = gridDim.x;
  return key != kEmptyKey ? (int)(((key * 2654435761u) >> 7) % g)
                          : (int)((unsigned)r % g);
}

// Several blocks: whether every valid row goes to the block of row 0's
// key `first` (kEmptyKey if row 0 is padding: then no), with part[j] the
// key of row r = threadIdx.x * kIpt + j (kEmptyKey: padding or r >= b) that
// picks its block. Then block 0 decides the batch alone, without the
// partition's check and own_rows: a batch of one tenant gains nothing from
// the spread. Every block gets the same answer.
template <int kIpt>
__device__ __forceinline__ bool one_block(uint32_t first,
                                          const uint32_t (&part)[kIpt]) {
  bool same = first != kEmptyKey;
  const int g = block_of(first, 0);
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    same &= part[j] == kEmptyKey || block_of(part[j], 0) == g;
  }
  return __syncthreads_and(same);
}

// The rows this block decides: every row of the batch (`all`), or, in a
// launch of several blocks, those with block_of(key, r) == blockIdx.x, in
// request order, in sub (kT x kIpt entries; temp is the count's scan
// storage). key[j] is row r = threadIdx.x * kIpt + j's slot (kEmptyKey:
// padding or r >= b). Returns their number m; position i < m is row
// (all ? i : sub[i]).
template <int kT, int kIpt>
__device__ int own_rows(typename Block<kT, kIpt>::Count::TempStorage& temp,
                        uint16_t* sub, int32_t b, bool all,
                        const uint32_t (&key)[kIpt]) {
  if (all) return b;
  const int tid = threadIdx.x;
  int flag[kIpt], pos[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int r = tid * kIpt + j;
    flag[j] = r < b && block_of(key[j], r) == (int)blockIdx.x;
  }
  int m;
  __syncthreads();  // the last use of the scan's storage is over
  typename Block<kT, kIpt>::Count(temp).ExclusiveSum(flag, pos, m);
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    if (flag[j]) sub[pos[j]] = (uint16_t)(tid * kIpt + j);
  }
  __syncthreads();
  return m;
}

// Bits of a hash set for m keys at load factor <= 1/2 (at least 64 entries).
__device__ __forceinline__ int hash_bits(int m) {
  int bits = 6;
  while ((1 << bits) < 2 * m) ++bits;
  return bits;
}

// Empty the first 2^bits entries of the set; starts with a barrier, so the
// set may be reused.
template <int kT, int kIpt>
__device__ __forceinline__ void clear_set(
    typename Block<kT, kIpt>::Shared& sh, int bits, uint32_t value) {
  __syncthreads();  // the last use of the set is over
  for (int i = threadIdx.x; i < (1 << bits) / 4; i += kT) {
    reinterpret_cast<uint4*>(sh.hkey)[i] =
        make_uint4(kEmptyKey, kEmptyKey, kEmptyKey, kEmptyKey);
    reinterpret_cast<uint4*>(sh.hval)[i] =
        make_uint4(value, value, value, value);
  }
  if (threadIdx.x == 0) sh.n_rep = 0;
  __syncthreads();
}

// The entry of slot `key` (claimed if new: `claimed` is then true).
__device__ __forceinline__ uint32_t set_entry(uint32_t* hkey, int bits,
                                              uint32_t key, bool& claimed) {
  uint32_t at = (key * 2654435761u) >> (32 - bits);
  for (;;) {
    const uint32_t cur = atomicCAS(&hkey[at], kEmptyKey, key);
    if (cur == kEmptyKey || cur == key) {
      claimed = cur == kEmptyKey;
      return at;
    }
    at = (at + 1) & ((1u << bits) - 1);
  }
}

// Several blocks: whether some slot's rows (key[j] of row r = threadIdx.x *
// kIpt + j) fall in two blocks of the partition by part[j] (block_of).
// Every block reads all b rows and gets the same answer.
template <int kT, int kIpt>
__device__ bool split_slots(typename Block<kT, kIpt>::Shared& sh, int32_t b,
                            const uint32_t (&key)[kIpt],
                            const uint32_t (&part)[kIpt]) {
  const int lane = threadIdx.x & 31;
  const int bits = hash_bits(b);
  clear_set<kT, kIpt>(sh, bits, kEmptyKey);
  // The first row of a slot to claim its entry leaves its block there (one
  // claim a slot a warp) ...
  uint32_t at[kIpt], g[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    g[j] = (uint32_t)block_of(part[j], threadIdx.x * kIpt + j);
    const unsigned peers = __match_any_sync(kFullMask, key[j]);
    const int leader = __ffs(peers) - 1;
    uint32_t h = 0;
    if (key[j] != kEmptyKey && lane == leader) {
      bool claimed;
      h = set_entry(sh.hkey, bits, key[j], claimed);
      if (claimed) sh.hval[h] = g[j];
    }
    at[j] = __shfl_sync(kFullMask, h, leader);
  }
  __syncthreads();
  // ... and every row of the slot compares its own with it.
  bool split = false;
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    split |= key[j] != kEmptyKey && sh.hval[at[j]] != g[j];
  }
  return __syncthreads_or(split);
}

// Position i = threadIdx.x * kIpt + j < m holds key[j] (its slot, or
// kEmptyKey for padding; positions >= m hold kEmptyKey). Returns the number
// of slots with more than one row (block-uniform). For each position:
// rep[j] the slot's compact id (0 ... n - 1) if the slot repeats, else -1.
template <int kT, int kIpt>
__device__ int find_repeats(typename Block<kT, kIpt>::Shared& sh, int m,
                            const uint32_t (&key)[kIpt],
                            int32_t (&rep)[kIpt]) {
  const int lane = threadIdx.x & 31;
  const int bits = hash_bits(m);
  clear_set<kT, kIpt>(sh, bits, 0);
  // Count: lanes of one slot count together; the lane that claims the
  // entry is the slot's owner.
  int32_t e[kIpt];
  bool owner[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const unsigned peers = __match_any_sync(kFullMask, key[j]);
    const int leader = __ffs(peers) - 1;
    int32_t h = -1;
    owner[j] = false;
    if (key[j] != kEmptyKey && lane == leader) {
      const uint32_t at = set_entry(sh.hkey, bits, key[j], owner[j]);
      atomicAdd(&sh.hval[at], (uint32_t)__popc(peers));
      h = (int32_t)at;
    }
    e[j] = __shfl_sync(kFullMask, h, leader);
  }
  __syncthreads();
  uint32_t cnt[kIpt];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    cnt[j] = e[j] >= 0 ? sh.hval[e[j]] : 0;
    any |= cnt[j] > 1;
  }
  if (!__syncthreads_or(any)) {
#pragma unroll
    for (int j = 0; j < kIpt; ++j) rep[j] = -1;
    return 0;
  }
  // Number the repeated slots: each owner takes an id (one atomic a warp)
  // and leaves it in the entry, over the count every row has read.
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const bool take = owner[j] && cnt[j] > 1;
    const unsigned took = __ballot_sync(kFullMask, take);
    int32_t base = 0;
    if (lane == 0 && took != 0) base = atomicAdd(&sh.n_rep, __popc(took));
    base = __shfl_sync(kFullMask, base, 0);
    if (take) {
      sh.hval[e[j]] = (uint32_t)(base + __popc(took & ((1u << lane) - 1)));
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    rep[j] = cnt[j] > 1 ? (int32_t)sh.hval[e[j]] : -1;
  }
  return sh.n_rep;
}

// Sort the positions stably by compact id (a lone slot's row, or padding,
// sorts after every id as the key n_rep, each its own segment):
// bit_length(n_rep) bits. On return k[j], pos[j] hold the thread's
// positions in sorted order, the keys are in sh.key by sorted position, and
// head[j] marks the first position of each segment. Requires n_rep >= 1.
template <int kT, int kIpt>
__device__ __forceinline__ void sort_repeats(
    typename Block<kT, kIpt>::Shared& sh, const int32_t (&rep)[kIpt],
    int n_rep, uint32_t (&k)[kIpt], uint16_t (&pos)[kIpt],
    bool (&head)[kIpt]) {
  using B = Block<kT, kIpt>;
  const int tid = threadIdx.x;
  const int bits = 32 - __clz(n_rep);
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    k[j] = rep[j] >= 0 ? (uint32_t)rep[j] : (uint32_t)n_rep;
    pos[j] = (uint16_t)(tid * kIpt + j);
  }
  __syncthreads();  // the last use of the sort's storage is over
  typename B::Sort(sh.temp.sort).Sort(k, pos, 0, bits);
#pragma unroll
  for (int j = 0; j < kIpt; ++j) sh.key[tid * kIpt + j] = k[j];
  __syncthreads();  // also: the sort's storage is free for the scans
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int p = tid * kIpt + j;
    head[j] = k[j] == (uint32_t)n_rep || p == 0 || sh.key[p - 1] != k[j];
  }
}

// Whether sorted position p (key k; keys by sorted position in skey) is
// the last of its segment.
template <int kT, int kIpt>
__device__ __forceinline__ bool segment_tail(
    const typename Block<kT, kIpt>::Shared& sh, const uint32_t* skey,
    uint32_t k, int n_rep, int p) {
  return k == (uint32_t)n_rep || p == Block<kT, kIpt>::kRows - 1 ||
         skey[p + 1] != k;
}

}  // namespace drl_batch
