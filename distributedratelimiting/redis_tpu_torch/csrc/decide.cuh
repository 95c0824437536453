// The decision machinery shared by the bucket and window kernels, for Hopper
// (sm_90a): the flush (plain and grouped), the bulk lane's scan, and the
// fingerprint decision (the flush and the scan over 64-bit keys, which
// resolve their cells in the same launch).
// acquire.cu instantiates it with the token bucket's rule, window.cu with the
// sliding/fixed window's. What differs between the two is only the rule for
// one slot, so every kernel here is a template on a policy P that holds it:
//
//   P::Table   the state pointers (a struct passed by value);
//   P::Params  the table's configuration (passed by value);
//   P::Old     a slot's state as gathered;
//   P::Slot    the slot's state advanced to the batch tick: what every row of
//              the slot decides from, and what is written back;
//   P::gather(table, s) -> Old
//   P::advance(old, now, params) -> Slot
//   P::fits(slot, now, params, pre, c) -> bool   the all-or-nothing grant of
//              a request for c after an earlier same-slot demand pre;
//   P::room(slot, now, params) -> float          what the slot holds before
//              the batch's demand: a row's remaining is
//              max((room - pre) - consumed, 0), and the grouped rule grants
//              clamp(floor((room - pre) / max(c, 1)), 0, n) members;
//   P::commit(table, s, slot, now, consumed)  the slot's one writer stores
//              the advanced state with the int64 sum of its consumption in
//              the batch (flush) or the chunk's last batch group (scan)
//              applied once;
//   P::carry(slot, now, consumed) -> Old     scan: the state commit would
//              store, as the next gather would read it, so that one slot's
//              batches chain in registers.
//
// Operands, as in the JAX package:
//   flush    i32[4, B]: row 0 slots (< 0 or >= N: padding, skipped as JAX's
//            mode="drop"), row 1 counts, row 2 the batch tick (column 0 is
//            read), row 3 the host's same-slot demand prefix;
//   grouped  i32[5, B]: rows 0-3 as above, row 4 the group size n;
//   scan     u8[K, B, 5] (bytes 0-3 the little-endian slot, byte 4 the
//            count), i32[2, K, B] (slots, counts), u8[K, B, 3] (a 24-bit
//            little-endian slot, count 1, 0xFFFFFF padding) or separate
//            slots, counts and valid arrays (ScanOp, below), and nows i32[K];
//            with dup false every row's same-batch prefix is 0;
//   fingerprint  u32[K, B, 3] (a key's lo, hi and count; count 0xFFFFFFFF
//            padding) against the fingerprint table (fp_probe.cuh), and
//            nows i32[K].
// Results: f32[2, B] (flush, grouped) or f32[K, 2, B] (scan): row 0 the grant
// (0/1) or n_granted, row 1 remaining; or, for a verdict-only scan, the
// grants bit-packed little-endian within each byte, u8[K, B / 8]. The
// fingerprint decision's row 0 is grant + 2 x resolved (padding counts as
// resolved), and its bits form is two planes, grants then resolve flags.
//
// Design. Every call is ONE launch.
//   - Flush and grouped (host prefix, no sort): a launch sized by its rows,
//     on batch.cuh's machinery. Every row decides from its slot's state as
//     gathered and the host's prefix; what the kernel must do besides is
//     give each slot one writer, which stores the advanced state with the
//     int64 sum of the slot's consumption (c a granted row, n_granted x c a
//     group) through P::commit. No float atomics: tokens and window counts
//     are deterministic, and equal to the plain version's row-by-row
//     arithmetic bit for bit for whole counts below 2^24 (a bucket's refilled
//     balance may be fractional; where the host's prefix covers the slot's
//     earlier demand, as the store's does, the granted consumption is at
//     most the balance and each subtraction of a whole count is exact).
//       B <= 32 (the server's scalar lane: nearly every launch): one warp,
//     row = lane; __match_any_sync gives each row its slot's peers, the
//     highest peer writes with their sum (peer_sum, from a 32-entry buffer;
//     skipped where no slot repeats). No block barrier, no atomics.
//       33 <= B <= 4096: blocks sized by B (64 x 1 ... 1024 x 4 rows), and
//     above 256 rows min(64, B / 64) of them, each taking the rows of its
//     share of the slots (own_rows: a hash of the slot), so that a slot's
//     rows meet in one block and no block waits for another. A block's rows
//     spread over all its warps first (position j * kT + thread). In a block
//     the lanes of one slot in a warp add their consumption together (the
//     lowest lane sums them with peer_sum) into the slot's entry of a hash
//     set in shared memory, an int64 accumulator whose sum does not depend
//     on the atomics' order; the row that claimed the entry writes the slot
//     after one barrier. Two barriers a block; no sort, since no prefix is
//     computed.
//       B > 4096 is refused (cudaErrorInvalidValue; the wrappers raise
//     first): a card store takes max_batch <= 4096, and its flushes, grouped
//     flushes and the bulk lane's one-batch chunks are at most that wide.
//     The flush is latency-bound, not bandwidth-bound: at B = 4096 its bytes
//     take well under a microsecond, and what it costs is the launch, the
//     barriers and one SM's scattered gathers and writes (hence the spread).
//   - Scan (bulk lane): the chunk's K batches are decided slot-major, not
//     batch by batch. What the plain version computes, per batch k in
//     order, is: every row of slot s is granted iff fits(advance(state_s,
//     now_k), pre, c), pre the int64 sum of the earlier rows of s in batch k;
//     s then keeps that state with batch k's granted sum applied. So one
//     slot's batches form a chain that no other slot touches: with the
//     slot's rows in (k, row) order, one gather, a walk over its batch
//     groups (advance, decide every row of the group from that state and its
//     prefix, sum the grants, carry) and one commit give the same answers.
//     The serial depth is per slot and at most K. ONE cooperative launch of
//     as many resident blocks of 512 threads as the chunk has rows for (two
//     an SM: a chunk of 32 x 4096 rows fills every SM), with grid.sync()
//     between its phases. A store sends a chunk of one batch (K = 1, the
//     coalescing lane's frames) to the flush instead, with the host's
//     prefix: the same policy (P::fits, P::room) decides the same rows, and
//     the flush's launch is sized by the rows, not by max_batch. The scan
//     takes any K all the same.
//       1. empty the chunk's hash set (in scratch the wrapper allocates);
//       2. every row inserts its slot (warp-aggregated: one atomic per slot a
//          warp) and counts its rows;
//       3. a row whose slot appears once in the chunk (the 10M-key bulk's
//          every row) decides at once: gather, decide with prefix 0, commit,
//          grant bits stored a 32-row word at a time; each slot that repeats
//          takes a segment number and its range in the slot-major order from
//          one 64-bit atomic (the count of segments and of rows in its two
//          halves), and a class by its rows: short (<= 8), middling (<= 256)
//          or long. A chunk in which no slot repeats (step 2 tells: a slot
//          found already inserted, or twice in a warp) skips the count
//          checks and ends here;
//       4. every repeated slot's rows are placed in its range: a short or
//          middling slot's in any order (one atomic a slot a warp), a long
//          slot's in (k, row) order by one stable multisplit over the long
//          slots (at most 510 in a chunk of 2^17 rows): a per-tile count, a
//          grid.sync(), a scatter in which every tile of 2048 rows sorts its
//          long rows with cub::BlockRadixSort (stable) and adds the earlier
//          tiles' counts, and a grid.sync();
//       5. every repeated slot is walked once. A short slot by one thread: a
//          sorting network orders its rows in registers, and the chain runs
//          there. A middling one by a warp: its rows are ranked in shared
//          memory (rows are distinct), then 32 at a time each lane finds its
//          batch group and its same-batch int64 prefix (a segmented warp
//          scan), and the groups go in order, each deciding from its
//          advanced state with a warp sum of its grants. A long one (a Zipf
//          chunk's hottest slot holds ~18% of the rows) by a whole block, 2048
//          rows at a time: one segmented cub::BlockScan gives every row its
//          prefix and its batch group, and each group takes two barriers
//          (decide, then a warp sum of its grants that warp 0 adds up). No
//          monotonicity of the grants in the prefix is assumed: every row is
//          tested.
//     Each slot is gathered once and committed once per chunk, by one
//     writer, so the table is deterministic and has no atomics. Grant bits
//     of repeated slots are ORed into the words step 3 stored.
//     Why not one grid-wide radix sort of every repeated row by slot: it
//     needs bit_length(segments) / 8 passes of two barriers each, over rows
//     that mostly belong to short slots; here only the long slots' rows are
//     sorted (one pass), and a short or middling slot's few rows are ordered
//     by their own walker without a barrier.
//   - Fingerprint decision (K batches of 64-bit keys, one launch; every
//     probe the group probe of fp_probe.cuh, a step of which reads 32 / G
//     windows, G lanes each). The rows of one key in a launch share one
//     cell or are all unresolved, so a key's rows are a cell's rows.
//       K = 1, B <= 4096 (every fingerprint flush, and the bulk lane's
//     one-batch calls): the flush, sized by its rows, with the prefix
//     computed on the card instead of by the host. B <= 32: a few warps
//     probe 32 / G rows each into shared memory, then one warp decides as
//     flush_warp_kernel does (peers by __match_any_sync on the cell, lane
//     order is request order: a row's prefix is the int64 sum of its lower
//     peers' counts). Above: blocks of 1024 threads own the rows of a
//     31-bit hash of the key (own_rows: a key holds one cell, so this
//     partitions the cells); a block probes its rows spread over its 32
//     warps (one step up to 256 rows), then batch.cuh's find_repeats, and
//     where a cell repeats sort_repeats and two segmented int64 scans give
//     each row its prefix and each cell its consumption, written once by
//     the cell's last row. Bits are set or cleared a row at a time (a
//     block's rows are not whole words): no zeroing launch.
//       Otherwise two launches on one stream: fp_probe.cuh's resolve_kernel
//     (32 / G rows a warp: one probe step) writes the kOpI32 operand into
//     the scan's scratch, then the scan's fingerprint form (kFpOps, the
//     narrow scan) decides it. An unresolved row's slot reads
//     kUnresolvedSlot (denied, code 0), a padding row's -1 (code 2). Its
//     stores write grant + 2 (every decided row is resolved) and, in the
//     bits form, step 3 stores the resolve plane's words beside the
//     grants'. The counts row of the operand is what the mesh's global
//     tier reads. (The resolve as the scan's first phase, before its first
//     grid.sync(), measured slower: PERF.md §6.)
//
// Traps, each with a test:
//   - Warp collectives: every lane reaches every __match_any_sync and
//     __shfl_sync (a padding lane carries kEmptyKey and adds 0), none stands
//     to the right of && or in a branch a lane may skip: a lane that misses
//     one hangs the warp.
//   - Stale reads. The scan writes the table it reads, so no state pointer is
//     const __restrict__ and none is read with __ldg; scratch that other
//     blocks wrote before a grid.sync() is read with __ldcg (L2), never
//     through a possibly stale L1 line.
//   - Exactness. The policies round every product and sum on their own
//     (__fmul_rn/__fadd_rn/__fdiv_rn, and the build passes -fmad=false): a
//     contracted FMA flips grants at the grant boundary.
//   - Counts above 2^24 (i32 operand): the prefix is summed in int64 and
//     converted once (__ll2float_rn), where the plain version converts it.
//   - Tables that grew: N need not be a power of two and may pass 2^24; the
//     scan never sorts by slot (it hashes slots and sorts long-slot
//     numbers), so N sets no bit range.
//   - Bit order: grant of row 8q + i is bit i of byte q, as
//     np.unpackbits(..., bitorder="little") reads it.

#pragma once

#include <cooperative_groups.h>

#include "batch.cuh"
#include "fp_probe.cuh"

namespace drl {

namespace cg = cooperative_groups;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Rows a flush block takes (1024 threads x 4): the widest flush.
constexpr int kFlushBlockRows = 4096;

// ---------------------------------------------------------------------------
// Flush and grouped flush: a launch sized by its rows.

// One row's result: its grant (0/1, or the members granted), its remaining,
// and its consumption in int64 (c, or n_granted x c).
struct FlushRow {
  float granted, remaining;
  long long used;
};

// Row r's operand: its count, the host's same-slot prefix (row 3) and, for
// a group, its size (row 4). Loaded with the slot, before any barrier, so
// that its latency hides behind the gathers'.
struct FlushIn {
  int32_t cnt, pre, n;
};

template <bool kGrouped>
__device__ __forceinline__ FlushIn load_row(const int32_t* packed, int32_t b,
                                            int r) {
  return FlushIn{packed[b + r], packed[3 * b + r],
                 kGrouped ? packed[4 * b + r] : 0};
}

// A row's all-or-nothing decision for cnt from its slot's advanced state sl
// (Slot{} for padding) after an earlier same-slot demand pre.
template <class P>
__device__ __forceinline__ FlushRow decide_one(const typename P::Slot& sl,
                                               bool valid, int32_t now,
                                               const typename P::Params& prm,
                                               int32_t cnt, float pre) {
  const float c = __int2float_rn(cnt);
  const bool ok = valid && P::fits(sl, now, prm, pre, c);
  const float room = P::room(sl, now, prm);
  return FlushRow{
      ok ? 1.0f : 0.0f,
      valid ? fmaxf(__fsub_rn(__fsub_rn(room, pre), ok ? c : 0.0f), 0.0f)
            : 0.0f,
      ok ? (long long)cnt : 0};
}

// A row's decision from its slot's advanced state sl (Slot{} for padding)
// and its operand.
template <class P, bool kGrouped>
__device__ __forceinline__ FlushRow decide_row(const typename P::Slot& sl,
                                               bool valid, int32_t now,
                                               const typename P::Params& prm,
                                               const FlushIn& in) {
  const int32_t cnt = in.cnt;
  const float c = __int2float_rn(cnt);
  const float pre = __int2float_rn(in.pre);
  if (kGrouped) {
    const float n = __int2float_rn(in.n);
    const float avail = __fsub_rn(P::room(sl, now, prm), pre);
    float ng;
    if (c > 0.0f) {
      ng = fminf(fmaxf(floorf(__fdiv_rn(avail, fmaxf(c, 1.0f))), 0.0f), n);
    } else {
      ng = avail >= 0.0f ? n : 0.0f;
    }
    const float granted = valid ? ng : 0.0f;
    const float consumed = __fmul_rn(granted, c);
    return FlushRow{granted,
                    valid ? fmaxf(__fsub_rn(avail, consumed), 0.0f) : 0.0f,
                    (long long)granted * cnt};
  }
  return decide_one<P>(sl, valid, now, prm, cnt, pre);
}

// B <= 32: row = lane. The highest lane of a slot's peers writes it once
// with the int64 sum of their consumption.
template <class P, bool kGrouped>
__global__ void __launch_bounds__(32, 1)
    flush_warp_kernel(typename P::Table T, int32_t n_slots,
                      const int32_t* __restrict__ packed, int32_t b,
                      typename P::Params prm, float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int32_t now = packed[2 * b];
  const int32_t s = lane < b ? packed[lane] : -1;
  FlushIn in{0, 0, 0};
  if (lane < b) in = load_row<kGrouped>(packed, b, lane);
  const bool valid = s >= 0 && s < n_slots;
  typename P::Slot sl{};
  if (valid) sl = P::advance(P::gather(T, s), now, prm);
  FlushRow row{0.0f, 0.0f, 0};
  if (lane < b) {
    row = decide_row<P, kGrouped>(sl, valid, now, prm, in);
    out[lane] = row.granted;
    out[b + lane] = row.remaining;
  }
  const unsigned me = 1u << lane;
  const unsigned peers =
      __match_any_sync(kFullMask, valid ? (uint32_t)s : kEmptyKey);
  const bool writer = valid && lane == 31 - __clz(peers);
  long long used = row.used;
  if (!__all_sync(kFullMask, !valid || peers == me)) {
    __shared__ long long buf[32];
    buf[lane] = row.used;
    __syncwarp();
    if (writer) used = drl_batch::peer_sum(buf, peers);
  }
  __syncwarp();  // every row has read its slot
  if (writer) P::commit(T, s, sl, now, used);
}

// Add each lane's consumption to its slot's entry in a hash set of 2^bits
// entries (keys hkey, int64 sums sum; kEmptyKey: padding, which adds
// nothing), the lanes of one slot together: the lowest sums their values
// (through buf, the warp's 32 slots of a buffer) and finds or claims the
// entry. Returns the entry (-1 on the other lanes) and, in `owner`, whether
// this lane claimed it: the slot's one writer. Every lane of the warp calls
// it.
__device__ __forceinline__ int32_t add_to_set(uint32_t* hkey,
                                              unsigned long long* sum,
                                              long long* buf, int bits,
                                              uint32_t key, long long used,
                                              bool& owner) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFullMask, key);
  const bool lead = key != kEmptyKey && lane == __ffs(peers) - 1;
  long long total = used;
  if (__any_sync(kFullMask, key != kEmptyKey && peers != (1u << lane))) {
    buf[lane] = used;
    __syncwarp();
    if (lead) total = drl_batch::peer_sum(buf, peers);
    __syncwarp();  // the buffer is read before its next use
  }
  owner = false;
  int32_t e = -1;
  if (lead) {
    e = (int32_t)drl_batch::set_entry(hkey, bits, key, owner);
    if (total != 0) atomicAdd(&sum[e], (unsigned long long)total);
  }
  return e;
}

// A flush block's shared memory: batch.cuh's partition (own_rows) and a
// hash set of keys with int64 sums; none of the admission kernels' sort.
template <int kT, int kIpt>
struct FlushShared {
  using Blk = drl_batch::Block<kT, kIpt>;
  typename Blk::Count::TempStorage count;  // own_rows'
  alignas(16) uint32_t hkey[Blk::kHash];   // an entry's slot
  alignas(16) unsigned long long sum[Blk::kHash];
  uint16_t sub[Blk::kRows];  // several blocks: the block's rows, in order
  long long buf[kT];         // add_to_set's, a warp's 32 at a time
};

// 33 <= B <= kT x kIpt, on G blocks: each decides the rows of its share of
// the slots (batch.cuh's own_rows), position i = j * kT + threadIdx.x of its
// m rows: a block's rows spread over all its warps before any warp takes a
// second (one slot's 700 rows of a Zipf batch take 22 warps, not 6).
template <class P, bool kGrouped, int kT, int kIpt>
__global__ void __launch_bounds__(kT, 1)
    flush_block_kernel(typename P::Table T, int32_t n_slots,
                       const int32_t* __restrict__ packed, int32_t b,
                       typename P::Params prm, float* __restrict__ out) {
  using Sh = FlushShared<kT, kIpt>;
  extern __shared__ __align__(16) unsigned char smem[];
  Sh& sh = *reinterpret_cast<Sh*>(smem);
  const int tid = threadIdx.x;
  const bool all = gridDim.x == 1;
  const int32_t now = packed[2 * b];
  auto slot_key = [&](int r) {
    const int32_t s = r < b ? packed[r] : -1;
    return s >= 0 && s < n_slots ? (uint32_t)s : kEmptyKey;
  };
  uint32_t key[kIpt];
  if (!all) {
#pragma unroll
    for (int j = 0; j < kIpt; ++j) key[j] = slot_key(tid * kIpt + j);
  }
  const int m =
      drl_batch::own_rows<kT, kIpt>(sh.count, sh.sub, b, all, key);
  if (m == 0) return;  // none of the batch's slots is this block's
  // Row steps j whose positions of this warp all lie at or past m are idle
  // (warp-uniform; every later step too).
  const int steps = (m - (tid & ~31) + kT - 1) / kT;

  // 1. Each row's slot, operand and state, the loads in flight while the
  //    set is emptied.
  int r[kIpt];
  FlushIn in[kIpt];
  typename P::Old old[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int i = j * kT + tid;
    r[j] = i >= m ? b : all ? i : (int)sh.sub[i];
    key[j] = slot_key(r[j]);
    if (r[j] < b) in[j] = load_row<kGrouped>(packed, b, r[j]);
    if (key[j] != kEmptyKey) old[j] = P::gather(T, (int32_t)key[j]);
  }
  const int bits = drl_batch::hash_bits(m);
  for (int i = tid; i < (1 << bits) / 4; i += kT) {
    reinterpret_cast<uint4*>(sh.hkey)[i] =
        make_uint4(kEmptyKey, kEmptyKey, kEmptyKey, kEmptyKey);
  }
  for (int i = tid; i < (1 << bits) / 2; i += kT) {
    reinterpret_cast<uint4*>(sh.sum)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // 2. Decide and reply; each slot's consumption goes to its entry.
  typename P::Slot sl[kIpt];
  int32_t e[kIpt];
  bool owner[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    owner[j] = false;
    if (j < steps) {
      const bool valid = key[j] != kEmptyKey;
      sl[j] = valid ? P::advance(old[j], now, prm) : typename P::Slot{};
      FlushRow row{0.0f, 0.0f, 0};
      if (r[j] < b) {
        row = decide_row<P, kGrouped>(sl[j], valid, now, prm, in[j]);
        out[r[j]] = row.granted;
        out[b + r[j]] = row.remaining;
      }
      e[j] = add_to_set(sh.hkey, sh.sum, sh.buf + (tid & ~31), bits,
                        key[j], row.used, owner[j]);
    }
  }
  __syncthreads();  // every row has read its slot and added to its entry

  // 3. Each slot's one writer: the row that claimed its entry.
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    if (owner[j]) {
      P::commit(T, (int32_t)key[j], sl[j], now, (long long)sh.sum[e[j]]);
    }
  }
}

template <class P, bool kGrouped, int kT, int kIpt>
int launch_flush_block(typename P::Table T, int32_t n_slots,
                       const int32_t* packed, int32_t b,
                       typename P::Params prm, float* out,
                       cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(FlushShared<kT, kIpt>);
  static_assert(kSmem <= 232448, "fits in an SM's shared memory");
  if constexpr (kSmem > 48 * 1024) {
    // Past 48 KB of dynamic shared memory the kernel must be allowed it:
    // once per device, not per launch.
    static bool allowed[64] = {false};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !allowed[dev]) {
      err = cudaFuncSetAttribute(flush_block_kernel<P, kGrouped, kT, kIpt>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) allowed[dev] = true;
    }
  }
  flush_block_kernel<P, kGrouped, kT, kIpt>
      <<<drl_batch::launch_blocks(b), kT, kSmem, stream>>>(T, n_slots, packed,
                                                           b, prm, out);
  return (int)cudaGetLastError();
}

// b <= kFlushBlockRows; a wider flush is refused.
template <class P, bool kGrouped>
int launch_flush(typename P::Table T, int32_t n_slots, const int32_t* packed,
                 int32_t b, typename P::Params prm, float* out,
                 cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (b > kFlushBlockRows) return (int)cudaErrorInvalidValue;
  if (b <= drl_batch::kWarpRows) {
    flush_warp_kernel<P, kGrouped><<<1, 32, 0, stream>>>(T, n_slots, packed,
                                                         b, prm, out);
    return (int)cudaGetLastError();
  }
  if (b <= 64)
    return launch_flush_block<P, kGrouped, 64, 1>(T, n_slots, packed, b, prm,
                                                  out, stream);
  if (b <= 256)
    return launch_flush_block<P, kGrouped, 256, 1>(T, n_slots, packed, b,
                                                   prm, out, stream);
  if (b <= 1024)
    return launch_flush_block<P, kGrouped, 1024, 1>(T, n_slots, packed, b,
                                                    prm, out, stream);
  if (b <= 2048)
    return launch_flush_block<P, kGrouped, 1024, 2>(T, n_slots, packed, b,
                                                    prm, out, stream);
  return launch_flush_block<P, kGrouped, 1024, 4>(T, n_slots, packed, b, prm,
                                                  out, stream);
}

// ---------------------------------------------------------------------------
// Segmented int64 sums (batch.cuh's Seg), also counting the heads up to each
// element: a block walk's prefixes and batch groups from one scan.
struct SegHeads {
  long long sum;
  int head;
  int heads;
};

struct SegHeadsSum {
  __device__ __forceinline__ SegHeads operator()(const SegHeads& a,
                                                 const SegHeads& b) const {
    return b.head >= 0 ? SegHeads{b.sum, b.head, a.heads + b.heads}
                       : SegHeads{a.sum + b.sum, a.head, a.heads + b.heads};
  }
};

// ---------------------------------------------------------------------------
// Scan: a chunk of K batches, decided slot-major on the whole grid.

constexpr int kScanThreads = 512;
constexpr int kScanIpt = 4;
constexpr int kScanTile = kScanThreads * kScanIpt;  // rows a block holds
// Rows a launch takes: K x B <= 32 x 4096, the store's largest chunk.
constexpr int64_t kMaxRows = 131072;
// A repeated slot with at most kThreadSeg rows in the chunk is short (one
// thread walks it), with at most kWarpSeg middling (a warp), longer long (a
// block). A chunk holds at most kMaxRows / (kWarpSeg + 1) < kLongBins long
// slots.
constexpr int kThreadSeg = 8;
constexpr int kWarpSeg = 256;
constexpr int kLongBins = 512;
static_assert(kMaxRows / (kWarpSeg + 1) < kLongBins, "long slots fit");
static_assert(kLongBins <= kScanThreads, "one bin a thread");
// Rows (or hash entries) a thread loads at once in the row phases.
constexpr int kRowsInFlight = 4;
constexpr unsigned long long kEmptyEntry =
    (unsigned long long)kEmptyKey << 32;

// The scan's scratch, carved from one allocation the wrapper makes (the
// kernel allocates nothing). R = K * B rows; the hash set has H = 2^hbits
// >= 4R entries (a load factor of at most 1/4 keeps linear probing's chains
// of dependent CASes short: at 1/2, a chunk of distinct keys took ~5 us
// longer on the H100, chip_smoke.py --scan-bench); at most R / 2 slots
// repeat.
struct ScanScratch {
  // [H] an entry: its slot (kEmptyKey: none) << 32 | its rows in the chunk
  unsigned long long* hent;
  int32_t* dense;     // [H] a repeated entry's segment number d
  int32_t* ent;       // [R] each row's entry, -1 for padding
  int32_t* seg_slot;  // [R/2 + 1] per segment d: its slot,
  int32_t* seg_base;  //   its first position in the sorted rows,
  int32_t* seg_len;   //   its rows
  int32_t* seg_bin;   //   its place among the long slots, or -1,
  int32_t* cursor;    //   and its rows placed so far (short and middling)
  int32_t* big;       // [kLongBins] the long slots' segments
  int32_t* mid;       // [R/2 + 1] the middling slots' segments
  int32_t* sorted;    // [R] the repeated slots' rows g = k * B + i, by slot
  int32_t* hist;      // [kLongBins][tiles rounded up to 4] long rows a tile
  unsigned long long* total;  // segments << 32 | rows of repeated slots
  int32_t* counters;  // [8]: long and middling slots, three work cursors,
                      // and whether any slot repeats
  uint32_t hbits;
  int64_t n_hash;
};

__host__ __device__ inline ScanScratch scan_scratch(void* base, int64_t rows,
                                                    size_t* bytes) {
  ScanScratch S;
  uint32_t hbits = 6;
  while ((int64_t(1) << hbits) < 4 * rows) ++hbits;
  const int64_t h = int64_t(1) << hbits;
  const int64_t half = rows / 2 + 1;
  const int64_t tiles = ((rows + kScanTile - 1) / kScanTile + 3) & ~3;
  unsigned char* p = static_cast<unsigned char*>(base);
  size_t o = 0;
  auto take = [&](size_t n) {
    unsigned char* q = p == nullptr ? nullptr : p + o;
    o += align16(n);
    return q;
  };
  S.hent = reinterpret_cast<unsigned long long*>(take(8 * h));
  S.dense = reinterpret_cast<int32_t*>(take(4 * h));
  S.ent = reinterpret_cast<int32_t*>(take(4 * rows));
  S.seg_slot = reinterpret_cast<int32_t*>(take(4 * half));
  S.seg_base = reinterpret_cast<int32_t*>(take(4 * half));
  S.seg_len = reinterpret_cast<int32_t*>(take(4 * half));
  S.seg_bin = reinterpret_cast<int32_t*>(take(4 * half));
  S.cursor = reinterpret_cast<int32_t*>(take(4 * half));
  S.big = reinterpret_cast<int32_t*>(take(4 * kLongBins));
  S.mid = reinterpret_cast<int32_t*>(take(4 * half));
  S.sorted = reinterpret_cast<int32_t*>(take(4 * rows));
  S.hist = reinterpret_cast<int32_t*>(take(4 * kLongBins * tiles));
  S.total = reinterpret_cast<unsigned long long*>(take(8));
  S.counters = reinterpret_cast<int32_t*>(take(32));
  S.hbits = hbits;
  S.n_hash = h;
  if (bytes != nullptr) *bytes = o;
  return S;
}

// A chunk's operand, in one of four formats (the entry points pass the
// format's number):
//   kOpI32     i32[2, K, B]: slots, then counts;
//   kOpFused5  u8[K, B, 5]: bytes 0-3 the little-endian slot, byte 4 the
//              count;
//   kOpSlots24 u8[K, B, 3]: the little-endian 24-bit slot, count 1; the id
//              0xFFFFFF (SLOT24_PAD) is padding and reads as -1;
//   kOpArrays  separate i32 slots (op), i32 counts and bool valid, each
//              [K * B]: an invalid row reads slot -1.
// Each batch's tick is nows_k[k], or, where nows_k is null, the operand's
// `now` (one batch whose tick the host passes by value).
// A slot < 0 or >= N is padding: it is denied and touches no state.
// The scan kernel is compiled in up to three forms per policy (kForm): the
// store's bulk lane (kNarrow: kOpI32 or kOpFused5, nows_k, the duplicate
// prefix) as it always was; a wide form (kWideOps) that takes every format, a
// by-value tick and dup false; and the fingerprint form (kFpOps), the narrow
// one over the kOpI32 operand the resolve launch wrote into scratch, whose
// stores carry the resolve flags (below). The bench's formats take the wide
// one, so the store's scan keeps its registers (one kernel over all four
// spilled ~5x more bytes in the window scan, chip_smoke.py's nvcc.log).
enum : int32_t { kOpI32 = 0, kOpFused5 = 1, kOpSlots24 = 2, kOpArrays = 3 };
enum : int { kNarrow = 0, kWideOps = 1, kFpOps = 2 };
// The fingerprint form's operand marks a valid row whose window is full
// (unresolved: denied, code 0) apart from padding (-1: code 2).
constexpr int32_t kUnresolvedSlot = -2;

struct ScanOp {
  const unsigned char* op;
  const int32_t* counts;  // kOpArrays only
  const uint8_t* valid;   // kOpArrays only
  int32_t fmt;
  int32_t now;  // the tick where nows_k is null
};

template <int kForm>
__device__ __forceinline__ int32_t tick_of(const ScanOp& o,
                                           const int32_t* nows_k, int32_t k) {
  if constexpr (kForm != kWideOps) return nows_k[k];
  return nows_k != nullptr ? nows_k[k] : o.now;
}

// Row g's slot and count (rows = K * B).
template <int kForm>
__device__ __forceinline__ int32_t op_slot(const ScanOp& o, int64_t g) {
  if constexpr (kForm != kWideOps) {
    if (o.fmt == kOpFused5) {
      const unsigned char* p = o.op + 5 * g;
      return (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                       ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
    }
    return reinterpret_cast<const int32_t*>(o.op)[g];
  }
  switch (o.fmt) {
    case kOpFused5: {
      const unsigned char* p = o.op + 5 * g;
      return (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                       ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
    }
    case kOpSlots24: {
      const unsigned char* p = o.op + 3 * g;
      const uint32_t s = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                         ((uint32_t)p[2] << 16);
      return s == 0xFFFFFFu ? -1 : (int32_t)s;
    }
    case kOpArrays:
      return o.valid[g] ? reinterpret_cast<const int32_t*>(o.op)[g] : -1;
    default:
      return reinterpret_cast<const int32_t*>(o.op)[g];
  }
}

template <int kForm>
__device__ __forceinline__ int32_t op_count(const ScanOp& o, int64_t rows,
                                            int64_t g) {
  if constexpr (kForm != kWideOps) {
    if (o.fmt == kOpFused5) return o.op[5 * g + 4];
    return reinterpret_cast<const int32_t*>(o.op)[rows + g];
  }
  switch (o.fmt) {
    case kOpFused5:
      return o.op[5 * g + 4];
    case kOpSlots24:
      return 1;
    case kOpArrays:
      return o.counts[g];
    default:
      return reinterpret_cast<const int32_t*>(o.op)[rows + g];
  }
}

// Count n rows of slot s in the chunk's hash set (open addressing, linear
// probing): a new slot's entry is claimed with its count in one 64-bit CAS;
// a slot another warp inserted first (`present`) adds n to the count's half.
// Returns the entry.
__device__ __forceinline__ int32_t hash_count(unsigned long long* hent,
                                              uint32_t hbits, uint32_t s,
                                              uint32_t n, bool& present) {
  const uint32_t mask = (1u << hbits) - 1;
  uint32_t h = (s * 2654435761u) >> (32 - hbits);
  for (;;) {
    const unsigned long long cur = atomicCAS(
        &hent[h], kEmptyEntry, ((unsigned long long)s << 32) | n);
    present = (uint32_t)(cur >> 32) == s;
    if (cur == kEmptyEntry) return (int32_t)h;
    if (present) {
      atomicAdd(&hent[h], (unsigned long long)n);
      return (int32_t)h;
    }
    h = (h + 1) & mask;
  }
}

__device__ __forceinline__ int32_t entry_rows(const unsigned long long* e) {
  return (int32_t)(uint32_t)__ldcg(e);
}

// One row's results: out f32[K, 2, B] (grant, remaining), or its grant bit
// g of the flat little-endian bit array (bit i of byte q is row 8q + i of
// the chunk, as bit i of u8[K, B / 8]'s byte q of batch k is row 8q + i of
// batch k when B % 8 == 0). kCode: a resolved fingerprint row, whose row 0
// is grant + 2.
template <bool kCode = false>
__device__ __forceinline__ void emit(float* out, uint8_t* bits, int32_t b,
                                     int64_t g, bool ok, float remaining) {
  if (out != nullptr) {
    const int64_t k = g / b;
    const int64_t o = k * 2 * b + (g - k * b);
    out[o] = kCode ? (ok ? 3.0f : 2.0f) : (ok ? 1.0f : 0.0f);
    out[o + b] = remaining;
  } else if (ok) {
    atomicOr(reinterpret_cast<unsigned int*>(bits) + (g >> 5),
             1u << (g & 31));
  }
}

// Shared memory of the scan kernel; the sort's and the segment walk's
// arrays are never live at once.
template <class P>
struct ScanShared {
  using Sort = cub::BlockRadixSort<uint32_t, kScanThreads, kScanIpt,
                                   uint16_t>;
  using ScanSegHeads = cub::BlockScan<SegHeads, kScanThreads,
                                      cub::BLOCK_SCAN_WARP_SCANS>;
  using ScanInt = cub::BlockScan<int, kScanThreads,
                                 cub::BLOCK_SCAN_WARP_SCANS>;
  union Temp {
    typename Sort::TempStorage sort;
    typename ScanSegHeads::TempStorage seg;
    typename ScanInt::TempStorage sint;
  };
  struct SortArrays {
    int32_t row[kScanTile];
    int32_t hist[kLongBins];
    int32_t off[kLongBins];    // a long slot's first output position here
    int32_t start[kLongBins];  // and its first position in the sorted tile
  };
  struct WalkArrays {
    int32_t gk[kScanTile + 1];    // per group of a window: its batch
    int32_t gnow[kScanTile + 1];  // and that batch's tick
    int32_t lastk[kScanThreads];
    long long part[kScanThreads / 32];  // a group's grants, per warp
    typename P::Old old;
    typename P::Slot sl;
    long long run, consumed;
    int32_t now, cur_k, first_head;
  };
  Temp temp;
  union {
    SortArrays sort;
    WalkArrays walk;
    int32_t warp[kScanThreads / 32][kWarpSeg];  // a middling slot's rows
  } u;
  int32_t item;
};

// What every walker reads: the table, the chunk's operand, ticks and
// results, and the repeated slots' rows in slot-major order.
template <class P, int kForm>
struct Chunk {
  typename P::Table T;
  ScanOp op;
  bool dup;  // false (kWideOps only): every row's same-batch prefix is 0
  int64_t rows;
  const int32_t* nows_k;
  int32_t b;
  typename P::Params prm;
  float* out;
  uint8_t* bits;
  const int32_t* sorted;

  __device__ int32_t count(int64_t g) const {
    return op_count<kForm>(op, rows, g);
  }
  __device__ int32_t tick(int32_t k) const {
    return tick_of<kForm>(op, nows_k, k);
  }
  // A row's prefix: its same-batch earlier demand, or 0 without the
  // duplicate serialization.
  __device__ float pre(long long demand) const {
    if constexpr (kForm != kWideOps) return __ll2float_rn(demand);
    return dup ? __ll2float_rn(demand) : 0.0f;
  }
  __device__ void emit(int64_t g, bool ok, float remaining) const {
    drl::emit<kForm == kFpOps>(out, bits, b, g, ok, remaining);
  }
};

// A short repeated slot (at most kThreadSeg rows), walked by one thread: its
// rows load at once (placed in no order), a sorting network puts them in
// (k, row) order, and the chain runs in registers.
template <class P, int kW>
__device__ void walk_short(const Chunk<P, kW>& ch, int32_t slot, int32_t base,
                           int32_t len) {
  int32_t gs[kThreadSeg], cs[kThreadSeg];
#pragma unroll
  for (int j = 0; j < kThreadSeg; ++j) {
    gs[j] = j < len ? __ldcg(&ch.sorted[base + j]) : 0x7FFFFFFF;
  }
#pragma unroll
  for (int r = 0; r < kThreadSeg; ++r) {  // odd-even transposition sort
#pragma unroll
    for (int j = r & 1; j + 1 < kThreadSeg; j += 2) {
      const int32_t lo = min(gs[j], gs[j + 1]);
      gs[j + 1] = max(gs[j], gs[j + 1]);
      gs[j] = lo;
    }
  }
#pragma unroll
  for (int j = 0; j < kThreadSeg; ++j) {
    if (j < len) cs[j] = ch.count(gs[j]);
  }
  typename P::Old old = P::gather(ch.T, slot);
  typename P::Slot sl{};
  int32_t cur_k = -1, now = 0;
  long long run = 0, consumed = 0;
#pragma unroll
  for (int j = 0; j < kThreadSeg; ++j) {
    if (j < len) {
      const int32_t k = gs[j] / ch.b;
      if (k != cur_k) {  // the slot's next batch: carry, then advance
        if (cur_k >= 0) old = P::carry(sl, now, consumed);
        now = ch.tick(k);
        sl = P::advance(old, now, ch.prm);
        run = 0;
        consumed = 0;
        cur_k = k;
      }
      const float pre = ch.pre(run);
      const float c = __int2float_rn(cs[j]);
      const bool ok = P::fits(sl, now, ch.prm, pre, c);
      ch.emit(gs[j], ok,
              fmaxf(__fsub_rn(__fsub_rn(P::room(sl, now, ch.prm), pre),
                              ok ? c : 0.0f),
                    0.0f));
      run += cs[j];
      if (ok) consumed += cs[j];
    }
  }
  P::commit(ch.T, slot, sl, now, consumed);
}

// The int64 sum over a warp.
__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
  return v;
}

// A middling repeated slot (at most kWarpSeg rows), walked by one warp. Its
// rows were placed in no order: they load into the warp's buffer in shared
// memory, and each lane ranks its rows among them (rows are distinct) and
// stores each at its rank, which puts them in (k, row) order. Then 32 rows
// at a time, one a lane: in each window the lanes find their batch group
// (a head where the batch changes), take their same-batch int64 prefix from
// a segmented warp scan, and the groups go in order: every lane computes the
// group's advanced state (the same value), the group's lanes decide, and a
// warp sum gives the group's grants.
template <class P, int kW>
__device__ void walk_warp(const Chunk<P, kW>& ch, int32_t slot, int32_t base,
                          int32_t len, int32_t* buf) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  constexpr int kPer = kWarpSeg / 32;
  int32_t mine[kPer], rank[kPer];
  __syncwarp();  // the last slot's walk has read the buffer
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = m * 32 + lane;
    mine[m] = i < len ? __ldcg(&ch.sorted[base + i]) : 0x7FFFFFFF;
    if (i < len) buf[i] = mine[m];
    rank[m] = 0;
  }
  __syncwarp();
  for (int i = 0; i < len; ++i) {
    const int32_t v = buf[i];
#pragma unroll
    for (int m = 0; m < kPer; ++m) rank[m] += v < mine[m];
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (m * 32 + lane < len) buf[rank[m]] = mine[m];
  }
  __syncwarp();
  typename P::Old old = P::gather(ch.T, slot);
  typename P::Slot sl{};
  int32_t cur_k = -1, now = 0;
  long long run = 0, consumed = 0;
  for (int32_t win = 0; win < len; win += 32) {
    const bool in = win + lane < len;
    const int32_t g = in ? buf[win + lane] : -1;
    const int32_t k = in ? g / ch.b : 0x7FFFFFFF;
    const int32_t c = in ? ch.count(g) : 0;
    int32_t prev_k = __shfl_up_sync(kFullMask, k, 1);
    if (lane == 0) prev_k = cur_k;
    const bool head = in && k != prev_k;
    const unsigned heads = __ballot_sync(kFullMask, head);
    // The lane's group starts at the last head at or below it (lane 0 if
    // none: the last window's group going on, which brings its demand).
    const unsigned upto = heads & (below | (1u << lane));
    const int start = upto ? 31 - __clz(upto) : 0;
    long long incl = c + (lane == 0 && !head ? run : 0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long up = __shfl_up_sync(kFullMask, incl, d);
      if (lane - d >= start) incl += up;
    }
    const float pre = ch.pre(incl - c);
    const float cf = __int2float_rn(c);
    unsigned left = __ballot_sync(kFullMask, in);
    const int last = 31 - __clz(left);
    while (left != 0) {
      const int first = __ffs(left) - 1;
      const int32_t kg = __shfl_sync(kFullMask, k, first);
      if ((heads >> first) & 1) {  // the slot's next batch
        if (cur_k >= 0) old = P::carry(sl, now, consumed);
        now = ch.tick(kg);
        sl = P::advance(old, now, ch.prm);
        consumed = 0;
        cur_k = kg;
      }
      const unsigned group = __ballot_sync(kFullMask, in && k == kg);
      bool ok = false;
      if ((group >> lane) & 1) {
        ok = P::fits(sl, now, ch.prm, pre, cf);
        ch.emit(g, ok,
                fmaxf(__fsub_rn(__fsub_rn(P::room(sl, now, ch.prm), pre),
                                ok ? cf : 0.0f),
                      0.0f));
      }
      consumed += warp_sum(ok ? (long long)c : 0);
      left &= ~group;
    }
    run = __shfl_sync(kFullMask, incl, last);
  }
  if (lane == 0) P::commit(ch.T, slot, sl, now, consumed);
}

// A long repeated slot (more than kWarpSeg rows, placed in (k, row) order),
// walked by the whole block: windows of kScanTile rows; in each, one
// segmented int64 scan gives every row its same-batch prefix and, counting
// the group heads, its group; then the groups
// go in order, each deciding its rows in parallel from its advanced state and
// summing its grants per warp, which warp 0 adds up before thread 0 carries
// the slot into the next group: two barriers a group.
template <class P, int kW>
__device__ void walk_long(ScanShared<P>& sh, const Chunk<P, kW>& ch,
                          int32_t slot, int32_t base, int32_t len) {
  using Sh = ScanShared<P>;
  auto& w = sh.u.walk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    w.old = P::gather(ch.T, slot);
    w.cur_k = -1;
    w.run = 0;
    w.consumed = 0;
    w.now = 0;
  }
  __syncthreads();
  const int32_t end = base + len;
  // The window's rows and counts; the next window's load while this one is
  // decided.
  int32_t g[kScanIpt], c[kScanIpt], nx_g[kScanIpt], nx_c[kScanIpt];
  auto load_rows = [&](int32_t win, int32_t (&rg)[kScanIpt]) {
#pragma unroll
    for (int j = 0; j < kScanIpt; ++j) {
      const int32_t idx = win + tid * kScanIpt + j;
      rg[j] = idx < end ? __ldcg(&ch.sorted[idx]) : -1;
    }
  };
  auto load_counts = [&](const int32_t (&rg)[kScanIpt],
                         int32_t (&rc)[kScanIpt]) {
#pragma unroll
    for (int j = 0; j < kScanIpt; ++j) {
      rc[j] = rg[j] >= 0 ? ch.count(rg[j]) : 0;
    }
  };
  load_rows(base, g);
  load_counts(g, c);
  for (int32_t win = base; win < end; win += kScanTile) {
    load_rows(win + kScanTile, nx_g);
    int32_t k[kScanIpt];
#pragma unroll
    for (int j = 0; j < kScanIpt; ++j) {
      k[j] = g[j] >= 0 ? g[j] / ch.b : 0x7FFFFFFF;
    }
    w.lastk[tid] = k[kScanIpt - 1];
    const int32_t carried_k = w.cur_k;
    const long long carried_run = w.run;
    __syncthreads();
    bool head[kScanIpt];
    SegHeads seg[kScanIpt];
#pragma unroll
    for (int j = 0; j < kScanIpt; ++j) {
      const int p = tid * kScanIpt + j;
      const int32_t prev =
          j > 0 ? k[j - 1] : (tid > 0 ? w.lastk[tid - 1] : carried_k);
      head[j] = g[j] >= 0 && k[j] != prev;
      // The window's first row, if it continues the last window's group,
      // starts from that group's running demand.
      seg[j] = SegHeads{c[j] + (p == 0 && !head[j] ? carried_run : 0),
                        head[j] ? p : -1, head[j] ? 1 : 0};
    }
    SegHeads agg;
    typename Sh::ScanSegHeads(sh.temp.seg).InclusiveScan(seg, seg,
                                                          SegHeadsSum(), agg);
    // seg[j].heads: the row's group (heads up to it); agg.heads: the
    // window's heads.
    const int n_heads = agg.heads;
#pragma unroll
    for (int j = 0; j < kScanIpt; ++j) {
      if (head[j]) {
        w.gk[seg[j].heads] = k[j];
        w.gnow[seg[j].heads] = ch.tick(k[j]);
      }
    }
    if (tid == 0) w.first_head = head[0];
    load_counts(nx_g, nx_c);
    __syncthreads();
    // Group 0 is the last window's group going on (if the first row is not
    // a head); group q >= 1 starts at the q-th head. Thread 0 carries the
    // slot into each new group.
    auto begin_group = [&](int q) {
      if (w.cur_k >= 0) w.old = P::carry(w.sl, w.now, w.consumed);
      w.now = w.gnow[q];
      w.sl = P::advance(w.old, w.now, ch.prm);
      w.consumed = 0;
      w.cur_k = w.gk[q];
    };
    const int q0 = w.first_head;
    if (tid == 0 && q0 == 1) begin_group(1);
    for (int q = q0; q <= n_heads; ++q) {
      __syncthreads();  // group q's state is set
      const typename P::Slot sl = w.sl;
      const int32_t now = w.now;
      long long part = 0;
#pragma unroll
      for (int j = 0; j < kScanIpt; ++j) {
        if (g[j] >= 0 && seg[j].heads == q) {
          const float pre = ch.pre(seg[j].sum - c[j]);
          const float cf = __int2float_rn(c[j]);
          const bool ok = P::fits(sl, now, ch.prm, pre, cf);
          ch.emit(g[j], ok,
                  fmaxf(__fsub_rn(__fsub_rn(P::room(sl, now, ch.prm), pre),
                                  ok ? cf : 0.0f),
                        0.0f));
          if (ok) part += c[j];
        }
      }
      part = warp_sum(part);
      if ((tid & 31) == 0) w.part[tid >> 5] = part;
      __syncthreads();
      if (tid < 32) {  // warp 0 adds the warps' sums
        part = warp_sum(tid < kScanThreads / 32 ? w.part[tid] : 0);
        if (tid == 0) {
          w.consumed += part;
          if (q < n_heads) begin_group(q + 1);
        }
      }
    }
    // The last group's running demand, for a group that goes on in the next
    // window.
    if (tid == 0) w.run = agg.sum;
#pragma unroll
    for (int j = 0; j < kScanIpt; ++j) {
      g[j] = nx_g[j];
      c[j] = nx_c[j];
    }
    __syncthreads();
  }
  if (tid == 0) P::commit(ch.T, slot, w.sl, w.now, w.consumed);
  __syncthreads();  // the walk arrays are free again
}

template <class P, int kForm>
__global__ void __launch_bounds__(kScanThreads, 2)
    scan_kernel(typename P::Table T, int32_t n_slots, ScanOp op, bool dup,
                const int32_t* __restrict__ nows_k, int32_t n_batches,
                int32_t b, typename P::Params prm, float* __restrict__ out,
                uint8_t* __restrict__ bits, void* scratch,
                uint32_t* __restrict__ res_bits) {
  using Sh = ScanShared<P>;
  __shared__ Sh sh;
  const int64_t rows = (int64_t)n_batches * b;
  const ScanScratch S = scan_scratch(scratch, rows, nullptr);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t gtid = (int64_t)blockIdx.x * kScanThreads + tid;
  const int64_t stride = (int64_t)gridDim.x * kScanThreads;
  constexpr int kR = kRowsInFlight;

  // 1. Empty the hash set and the counters (16 bytes, two entries, a store).
  for (int64_t i = gtid; i < S.n_hash / 2; i += stride) {
    reinterpret_cast<uint4*>(S.hent)[i] =
        make_uint4(0, kEmptyKey, 0, kEmptyKey);
  }
  if (gtid == 0) {
    *S.total = 0;
    for (int i = 0; i < 8; ++i) S.counters[i] = 0;
  }
  cg::this_grid().sync();

  // 2. Every valid row finds its slot's entry and counts itself; lanes of a
  //    warp with one slot count together. (Each thread loads kR rows' slots
  //    at once, here and below.)
  for (int64_t w0 = gtid - lane; w0 < rows; w0 += kR * stride) {
    int32_t sl[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int64_t g = w0 + j * stride + lane;
      sl[j] = g < rows ? op_slot<kForm>(op, g) : -1;
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int64_t g = w0 + j * stride + lane;
      if (g - lane >= rows) break;  // warp-uniform
      const int32_t s = sl[j];
      const bool valid = s >= 0 && s < n_slots;
      const unsigned peers =
          __match_any_sync(kFullMask, valid ? (uint32_t)s : kEmptyKey);
      const int leader = __ffs(peers) - 1;
      int32_t h = -1;
      bool again = false;  // the slot has another row in the chunk
      if (valid && lane == leader) {
        h = hash_count(S.hent, S.hbits, (uint32_t)s, __popc(peers), again);
        again |= peers != 1u << lane;
      }
      if (__any_sync(kFullMask, again) && lane == 0) S.counters[5] = 1;
      h = __shfl_sync(kFullMask, h, leader);
      if (g < rows) S.ent[g] = valid ? h : -1;
    }
  }
  cg::this_grid().sync();
  const bool repeats = __ldcg(&S.counters[5]) != 0;

  // 3. A slot with one row in the chunk decides it at once: one gather, one
  //    commit, no prefix. Padding rows answer (0, 0). Grant bits of 32 rows
  //    are one word, stored whole (a repeated slot's rows OR theirs in after
  //    the next barrier). A chunk without repeats ends here. Otherwise every
  //    repeated slot takes a segment number d and its range in the
  //    slot-major order from one 64-bit atomic, so ranges and numbers ascend
  //    together, and its class by its rows.
  for (int64_t w0 = gtid - lane; w0 < rows; w0 += kR * stride) {
    bool single[kR];
    int32_t sl[kR];
    typename P::Old old[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int64_t g = w0 + j * stride + lane;
      const int32_t e = g < rows ? S.ent[g] : -1;
      single[j] = e >= 0 && (!repeats || entry_rows(&S.hent[e]) == 1);
      sl[j] = single[j] ? op_slot<kForm>(op, g) : -1;
      if (out != nullptr && g < rows && e < 0) {
        // Padding (a resolved fingerprint row: code 2), or unresolved.
        if (kForm == kFpOps && op_slot<kForm>(op, g) == -1) {
          emit<true>(out, nullptr, b, g, false, 0.0f);
        } else {
          emit(out, nullptr, b, g, false, 0.0f);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (single[j]) old[j] = P::gather(T, sl[j]);
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int64_t g = w0 + j * stride + lane;
      if (g - lane >= rows) break;  // warp-uniform
      bool ok = false;
      if (single[j]) {
        const int32_t kk = (int32_t)(g / b);
        const int32_t now = tick_of<kForm>(op, nows_k, kk);
        const typename P::Slot st = P::advance(old[j], now, prm);
        const int32_t cnt = op_count<kForm>(op, rows, g);
        const float c = __int2float_rn(cnt);
        ok = P::fits(st, now, prm, 0.0f, c);
        if (out != nullptr) {
          emit<kForm == kFpOps>(out, nullptr, b, g, ok,
               fmaxf(__fsub_rn(__fsub_rn(P::room(st, now, prm), 0.0f),
                               ok ? c : 0.0f),
                     0.0f));
        }
        P::commit(T, sl[j], st, now, ok ? (long long)cnt : 0);
      }
      if (bits != nullptr) {
        const unsigned word = __ballot_sync(kFullMask, ok);
        if (lane == 0) {
          reinterpret_cast<unsigned int*>(bits)[(g - lane) >> 5] = word;
        }
        if constexpr (kForm == kFpOps) {  // the resolve plane, too
          const unsigned res = __ballot_sync(
              kFullMask,
              g < rows && op_slot<kForm>(op, g) != kUnresolvedSlot);
          if (lane == 0) res_bits[(g - lane) >> 5] = res;
        }
      }
    }
  }
  if (!repeats) return;  // every row was its slot's only one
  for (int64_t e0 = gtid - lane; e0 < S.n_hash; e0 += kR * stride) {
    int32_t cnts[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int64_t e = e0 + j * stride + lane;
      cnts[j] = e < S.n_hash ? entry_rows(&S.hent[e]) : 0;
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int64_t e = e0 + j * stride + lane;
      const int32_t cnt = cnts[j];
      const bool rep = cnt > 1;
      const unsigned mask = __ballot_sync(kFullMask, rep);
      if (mask == 0) continue;
      const int32_t v = rep ? cnt : 0;
      int32_t incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t up = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += up;
      }
      unsigned long long first = 0;
      if (lane == 31) {
        first = atomicAdd(S.total, ((unsigned long long)__popc(mask) << 32) |
                                       (unsigned long long)(uint32_t)incl);
      }
      first = __shfl_sync(kFullMask, first, 31);
      if (rep) {
        const int32_t d =
            (int32_t)(first >> 32) + __popc(mask & ((1u << lane) - 1));
        S.dense[e] = d;
        S.seg_slot[d] = (int32_t)(__ldcg(&S.hent[e]) >> 32);
        S.seg_base[d] = (int32_t)(uint32_t)first + incl - v;
        S.seg_len[d] = cnt;
        S.cursor[d] = 0;
        int32_t bin = -1;
        if (cnt > kWarpSeg) {
          bin = atomicAdd(&S.counters[0], 1);
          S.big[bin] = d;
        } else if (cnt > kThreadSeg) {
          S.mid[atomicAdd(&S.counters[1], 1)] = d;
        }
        S.seg_bin[d] = bin;
      }
    }
  }
  cg::this_grid().sync();
  const unsigned long long total = __ldcg(S.total);
  const int32_t n_seg = (int32_t)(total >> 32);

  // 4. Place every repeated slot's rows in its range of the sorted order.
  //    A short or middling slot's rows go anywhere in it (one atomic a
  //    slot a warp); their walkers order them. A long slot's rows are
  //    ordered here, by one stable multisplit: a per-tile count of each long
  //    slot's rows, a barrier, and a scatter (every tile sorts its rows by
  //    long slot with a block radix sort, stable, and adds the earlier
  //    tiles' counts), so each long slot's rows land in chunk order, that
  //    is (k, row) order. A row's entry becomes its long slot, or -1.
  const int32_t n_big = __ldcg(&S.counters[0]);
  const int32_t tiles = (int32_t)((rows + kScanTile - 1) / kScanTile);
  const int32_t tstride = (tiles + 3) & ~3;  // 16-byte rows of counts
  auto& sa = sh.u.sort;
  for (int32_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int i = tid; i < n_big; i += kScanThreads) sa.hist[i] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanIpt; ++j) {
      const int64_t g = (int64_t)t * kScanTile + j * kScanThreads + tid;
      int32_t d = -1, bin = -1;
      if (g < rows) {
        const int32_t e = __ldcg(&S.ent[g]);
        if (e >= 0 && entry_rows(&S.hent[e]) > 1) {
          d = __ldcg(&S.dense[e]);
          bin = __ldcg(&S.seg_bin[d]);
        }
        S.ent[g] = bin;
      }
      if (bin >= 0) atomicAdd(&sa.hist[bin], 1);
      const int32_t place = bin < 0 ? d : -1;
      const unsigned peers = __match_any_sync(kFullMask, (uint32_t)place);
      const int leader = __ffs(peers) - 1;
      int32_t at = 0;
      if (place >= 0 && lane == leader) {
        at = __ldcg(&S.seg_base[place]) +
             atomicAdd(&S.cursor[place], __popc(peers));
      }
      at = __shfl_sync(kFullMask, at, leader);
      if (place >= 0) S.sorted[at + __popc(peers & ((1u << lane) - 1))] = g;
    }
    __syncthreads();
    for (int i = tid; i < n_big; i += kScanThreads) {
      S.hist[(int64_t)i * tstride + t] = sa.hist[i];
    }
  }
  cg::this_grid().sync();
  const int wbits = n_big > 1 ? 32 - __clz(n_big - 1) : 1;
  const uint32_t none = 1u << wbits;  // sorts after every long slot
  for (int32_t t = blockIdx.x; n_big > 0 && t < tiles; t += gridDim.x) {
    uint32_t dig[kScanIpt];
    uint16_t val[kScanIpt];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kScanIpt; ++j) {
      const int p = tid * kScanIpt + j;
      const int64_t g = (int64_t)t * kScanTile + p;
      const int32_t bin = g < rows ? __ldcg(&S.ent[g]) : -1;
      dig[j] = bin >= 0 ? (uint32_t)bin : none;
      val[j] = (uint16_t)p;
      sa.row[p] = (int32_t)g;
      any |= bin >= 0;
    }
    if (!__syncthreads_or(any)) continue;
    // Per long slot: its rows in the earlier tiles and in this one.
    int32_t before = 0, here = 0;
    if (tid < n_big) {
      const int4* h =
          reinterpret_cast<const int4*>(S.hist + (int64_t)tid * tstride);
      // 64 tiles' counts (a whole chunk's) per round, all loads in flight.
      for (int32_t u0 = 0; u0 <= t; u0 += 64) {
        int4 v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          v[q] = u0 + 4 * q <= t ? __ldcg(&h[u0 / 4 + q])
                                 : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int32_t x[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int32_t u = u0 + 4 * q + r;
            if (u < t) before += x[r];
            if (u == t) here = x[r];
          }
        }
      }
    }
    int32_t start;
    typename Sh::ScanInt(sh.temp.sint).ExclusiveSum(here, start);
    if (tid < n_big) {
      sa.off[tid] = __ldcg(&S.seg_base[__ldcg(&S.big[tid])]) + before;
      sa.start[tid] = start;
    }
    __syncthreads();  // the scan's storage is the sort's
    typename Sh::Sort(sh.temp.sort).Sort(dig, val, 0, wbits + 1);
#pragma unroll
    for (int j = 0; j < kScanIpt; ++j) {
      if (dig[j] < none) {
        const int p = tid * kScanIpt + j;
        S.sorted[sa.off[dig[j]] + (p - sa.start[dig[j]])] = sa.row[val[j]];
      }
    }
    __syncthreads();
  }
  if (n_big > 0) cg::this_grid().sync();
  const Chunk<P, kForm> ch{T, op, dup, rows, nows_k, b, prm, out, bits,
                           S.sorted};

  // 5. Walk every repeated slot: the long ones a block each, taken from a
  //    queue, then the middling ones a warp each, then the short ones a
  //    thread each (a warp takes 32 segment numbers at a time). Each slot is
  //    gathered once and committed once.
  const int32_t n_mid = __ldcg(&S.counters[1]);
  for (;;) {
    if (tid == 0) sh.item = atomicAdd(&S.counters[2], 1);
    __syncthreads();
    const int32_t i = sh.item;
    __syncthreads();
    if (i >= n_big) break;
    const int32_t d = __ldcg(&S.big[i]);
    walk_long<P, kForm>(sh, ch, __ldcg(&S.seg_slot[d]),
                        __ldcg(&S.seg_base[d]), __ldcg(&S.seg_len[d]));
  }
  // From here every warp takes its own work: a warp segment, or 32 segment
  // numbers whose short segments its lanes walk.
  for (;;) {
    int32_t i = 0;
    if (lane == 0) i = atomicAdd(&S.counters[3], 1);
    i = __shfl_sync(kFullMask, i, 0);
    if (i >= n_mid) break;
    const int32_t d = __ldcg(&S.mid[i]);
    walk_warp<P, kForm>(ch, __ldcg(&S.seg_slot[d]), __ldcg(&S.seg_base[d]),
                        __ldcg(&S.seg_len[d]), sh.u.warp[tid >> 5]);
  }
  for (;;) {
    int32_t i = 0;
    if (lane == 0) i = atomicAdd(&S.counters[4], 1);
    const int64_t d = (int64_t)__shfl_sync(kFullMask, i, 0) * 32 + lane;
    if (d - lane >= n_seg) break;
    if (d < n_seg) {
      const int32_t len = __ldcg(&S.seg_len[d]);
      if (len <= kThreadSeg) {
        walk_short<P, kForm>(ch, __ldcg(&S.seg_slot[d]),
                             __ldcg(&S.seg_base[d]), len);
      }
    }
  }
}

// Resident blocks of one scan kernel instantiation on the current device: a
// cooperative grid may hold no more. Cached per device.
template <class P, int kForm>
int scan_grid_limit(int* limit) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev] > 0) {
    *limit = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scan_kernel<P, kForm>, kScanThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *limit = sms * per_sm;
  if (dev < 64) cached[dev] = *limit;
  return 0;
}

// Bytes of scratch a chunk of n_batches x b rows needs.
inline int64_t scan_scratch_bytes(int32_t n_batches, int32_t b) {
  size_t bytes = 0;
  scan_scratch(nullptr, (int64_t)n_batches * b, &bytes);
  return (int64_t)bytes;
}

// Exactly one of out (f32[K, 2, B]) and bits (u8[K, B / 8], B % 8 == 0, in
// a 4-byte aligned allocation rounded up to whole 4-byte words) is
// non-null; scratch holds scan_scratch_bytes(K, B) bytes. The narrow kernel
// takes kOpI32 or kOpFused5, nows_k and dup true; the wide one every
// format, a null nows_k (the operand's tick) and dup false, which gives
// every row prefix 0 (rows of one slot then all decide from its state); the
// fingerprint form the narrow one's arguments over the kOpI32 operand the
// resolve wrote, and for the bits result the resolve plane's words
// res_bits.
template <class P, int kForm>
int launch_scan(typename P::Table T, int32_t n_slots, const ScanOp& op,
                bool dup, const int32_t* nows_k, int32_t n_batches, int32_t b,
                typename P::Params prm, float* out, uint8_t* bits,
                void* scratch, cudaStream_t stream,
                uint32_t* res_bits = nullptr) {
  if (b <= 0 || n_batches <= 0) return (int)cudaSuccess;
  const int64_t rows = (int64_t)n_batches * b;
  if (rows > kMaxRows) return (int)cudaErrorInvalidValue;
  const int32_t last = kForm == kWideOps ? kOpArrays
                       : kForm == kFpOps ? kOpI32
                                         : kOpFused5;
  if (op.fmt < kOpI32 || op.fmt > last) return (int)cudaErrorInvalidValue;
  if (kForm != kWideOps && (nows_k == nullptr || !dup)) {
    return (int)cudaErrorInvalidValue;
  }
  int limit = 0;
  const int rc = scan_grid_limit<P, kForm>(&limit);
  if (rc != 0) return rc;
  if (limit <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  int64_t blocks = (rows + kScanThreads - 1) / kScanThreads;
  if (blocks > limit) blocks = limit;
  ScanOp o = op;
  void* args[] = {&T, &n_slots, &o, &dup, (void*)&nows_k, &n_batches,
                  &b, &prm, &out, &bits, &scratch, &res_bits};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)scan_kernel<P, kForm>, dim3((unsigned)blocks),
      dim3(kScanThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The bulk lane: one operand array, kOpI32 or kOpFused5 (the narrow
// kernel), each batch with its duplicate serialization.
template <class P>
int launch_scan_any(typename P::Table T, int32_t n_slots, const void* operand,
                    int32_t fmt, const int32_t* nows_k, int32_t n_batches,
                    int32_t b, typename P::Params prm, float* out,
                    uint8_t* bits, void* scratch, cudaStream_t stream) {
  const ScanOp op{static_cast<const unsigned char*>(operand), nullptr,
                  nullptr, fmt, 0};
  return launch_scan<P, kNarrow>(T, n_slots, op, true, nows_k, n_batches, b,
                                 prm, out, bits, scratch, stream);
}

// ---------------------------------------------------------------------------
// The fingerprint decision: K batches of keys u32[K, B, 3] resolved (the
// group probe, fp_probe.cuh) and decided against the table. K = 1 and B <=
// 4096 (every flush of a fingerprint store, and its bulk lane's one-batch
// calls) is ONE launch, a flush sized by its rows (fp_flush_*_kernel,
// below); anything else two: the resolve into the scan's operand, then the
// scan's fingerprint form.

// The flush form's operands and results: keys u32[B, 3]; the tick
// nows_k[0]; out f32[2, B] (row 0 grant + 2 * resolved, padding counting as
// resolved; row 1 remaining) or the bit planes at bits (u32 words: grants
// from word 0, resolve flags from word `plane`); counts i32[B] (max(count,
// 0)) where non-null.
struct FpFlush {
  drl_fp::Fp f;
  const uint32_t* keys;
  const int32_t* nows_k;
  float* out;
  uint32_t* bits;
  int32_t plane;
  int32_t* counts;
};

// Row r's f32 result and count (the bit planes are the callers').
__device__ __forceinline__ void fp_reply(const FpFlush& io, int32_t b, int r,
                                         const FlushRow& row, bool resolved,
                                         int32_t cnt) {
  if (io.out != nullptr) {
    io.out[r] = row.granted + (resolved ? 2.0f : 0.0f);
    io.out[b + r] = row.remaining;
  }
  if (io.counts != nullptr) io.counts[r] = cnt > 0 ? cnt : 0;
}

// Set or clear bit r of a plane: every row writes its own bit once, so the
// planes need no zeroing launch and the result is the same in any order.
__device__ __forceinline__ void put_bit(uint32_t* words, int r, bool on) {
  const uint32_t m = 1u << (r & 31);
  if (on) {
    atomicOr(&words[r >> 5], m);
  } else {
    atomicAnd(&words[r >> 5], ~m);
  }
}

// B <= 32: ceil(B / (32 / G)) warps probe, 32 / G rows each (one step of
// the group probe), and leave each row's cell in shared memory; warp 0
// then decides, row = lane: __match_any_sync on the cell gives each row its
// peers, lane order is request order, so a row's prefix is the int64 sum of
// its lower peers' counts and the highest peer writes the slot with their
// consumption (peer_sum, from a 32-entry buffer; skipped where no key
// repeats).
template <class P>
__global__ void __launch_bounds__(256, 1)
    fp_flush_warp_kernel(typename P::Table T, FpFlush io, int32_t b,
                         typename P::Params prm) {
  __shared__ int32_t cell[32];
  __shared__ long long buf[32];
  const int lane = threadIdx.x & 31;
  const int rpw = 32 / io.f.group;
  {
    const int r = (threadIdx.x >> 5) * rpw + lane;
    const bool in = lane < rpw && r < b;
    uint32_t lo = 0, hi = 0;
    int32_t cnt = -1;
    if (in) {
      lo = io.keys[3 * r];
      hi = io.keys[3 * r + 1];
      cnt = (int32_t)io.keys[3 * r + 2];
    }
    const int32_t s = drl_fp::warp_find_or_claim(
        io.f, ((unsigned long long)hi << 32) | lo, cnt >= 0);
    if (in) cell[r] = s;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int32_t now = io.nows_k[0];
  const unsigned me = 1u << lane;
  const int32_t cnt = lane < b ? (int32_t)io.keys[3 * lane + 2] : -1;
  const int32_t s = lane < b ? cell[lane] : -1;
  const bool live = s >= 0;
  typename P::Slot sl{};
  if (live) sl = P::advance(P::gather(T, s), now, prm);
  const unsigned peers =
      __match_any_sync(kFullMask, live ? (uint32_t)s : kEmptyKey);
  const bool alone = __all_sync(kFullMask, !live || peers == me);
  long long pre = 0;
  if (!alone) {
    buf[lane] = live ? cnt : 0;
    __syncwarp();
    if (live) pre = drl_batch::peer_sum(buf, peers & (me - 1));
    __syncwarp();  // the buffer is read before its next use
  }
  const FlushRow row =
      decide_one<P>(sl, live, now, prm, live ? cnt : 0,
                       __ll2float_rn(pre));
  const bool resolved = cnt < 0 || live;
  if (lane < b) fp_reply(io, b, lane, row, resolved, cnt);
  if (io.bits != nullptr) {
    const unsigned g = __ballot_sync(kFullMask, lane < b && row.granted > 0);
    const unsigned rs = __ballot_sync(kFullMask, lane < b && resolved);
    if (lane == 0) {
      io.bits[0] = g;
      io.bits[io.plane] = rs;
    }
  }
  const bool writer = live && lane == 31 - __clz(peers);
  long long used = row.used;
  if (!alone) {
    buf[lane] = row.used;
    __syncwarp();
    if (writer) used = drl_batch::peer_sum(buf, peers);
  }
  __syncwarp();  // every row has read its slot
  if (writer) P::commit(T, s, sl, now, used);
}

// A fingerprint flush block's shared memory: batch.cuh's partition, hash
// set and sort, and each position's cell.
template <int kT, int kIpt>
struct FpFlushShared {
  typename drl_batch::Block<kT, kIpt>::Shared blk;
  int32_t cell[kT * kIpt];
};

// 33 <= B <= 1024 x kIpt, on G blocks of 1024 threads (batch.cuh's
// launch_blocks): each decides the rows of its share of the KEYS (own_rows
// over a 31-bit hash of the 64-bit key: a key holds one cell, so this is a
// partition of the cells), in request order.
//   1. Probe: position p = j * kT + lane * 32 + warp, so a block's m rows
//      spread over its 32 warps first (m <= 256 rows: one step of the group
//      probe a warp); each position's cell goes to shared memory.
//   2. Decide, position i = threadIdx.x * kIpt + j (blocked, as the sort
//      wants): batch.cuh's find_repeats counts each cell's rows; where no
//      cell repeats every row decides at once (prefix 0) and writes its own
//      slot; otherwise sort_repeats orders the repeated cells' rows and two
//      segmented int64 scans give each row its same-cell prefix of earlier
//      demand and each cell's consumption, which the cell's last row writes
//      once (P::commit).
// Bits are set or cleared one row at a time (put_bit): a block's rows are
// not the words' 32 consecutive rows.
template <class P, int kT, int kIpt>
__global__ void __launch_bounds__(kT, 1)
    fp_flush_block_kernel(typename P::Table T, FpFlush io, int32_t b,
                          typename P::Params prm) {
  using Blk = drl_batch::Block<kT, kIpt>;
  using Sh = FpFlushShared<kT, kIpt>;
  extern __shared__ __align__(16) unsigned char smem[];
  Sh& shf = *reinterpret_cast<Sh*>(smem);
  typename Blk::Shared& sh = shf.blk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool all = gridDim.x == 1;
  const int32_t now = io.nows_k[0];
  auto count_of = [&](int r) {
    return r < b ? (int32_t)io.keys[3 * r + 2] : -1;
  };
  uint32_t key[kIpt];
  if (!all) {
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      const int r = tid * kIpt + j;
      key[j] = count_of(r) >= 0
                   ? ((io.keys[3 * r] * drl_fp::kMix) ^ io.keys[3 * r + 1]) >> 1
                   : kEmptyKey;
    }
  }
  const int m =
      drl_batch::own_rows<kT, kIpt>(sh.temp.count, sh.sub, b, all, key);
  if (m == 0) return;  // none of the batch's keys is this block's
  auto row_at = [&](int i) { return i >= m ? b : all ? i : (int)sh.sub[i]; };

  // 1. Probe.
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    if (j * kT + (tid >> 5) >= m) break;  // warp-uniform: lane 0's p
    const int p = j * kT + lane * (kT / 32) + (tid >> 5);
    const int r = row_at(p);
    const int32_t cnt = count_of(r);
    const uint32_t lo = cnt >= 0 ? io.keys[3 * r] : 0u;
    const uint32_t hi = cnt >= 0 ? io.keys[3 * r + 1] : 0u;
    const int32_t s = drl_fp::warp_find_or_claim(
        io.f, ((unsigned long long)hi << 32) | lo, cnt >= 0);
    if (p < m) shf.cell[p] = s;
  }
  __syncthreads();

  // 2. Decide.
  int32_t r[kIpt], cnt[kIpt], s[kIpt];
  typename P::Old old[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int i = tid * kIpt + j;
    r[j] = row_at(i);
    cnt[j] = count_of(r[j]);
    s[j] = i < m ? shf.cell[i] : -1;
    key[j] = s[j] >= 0 ? (uint32_t)s[j] : kEmptyKey;
    if (s[j] >= 0) old[j] = P::gather(T, s[j]);
  }
  int32_t rep[kIpt];
  const int n_rep = drl_batch::find_repeats<kT, kIpt>(sh, m, key, rep);
  if (n_rep == 0) {  // every live row alone: prefix 0, its own writer
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      if (r[j] >= b) continue;
      const bool live = s[j] >= 0;
      typename P::Slot sl{};
      if (live) sl = P::advance(old[j], now, prm);
      const FlushRow row =
          decide_one<P>(sl, live, now, prm, live ? cnt[j] : 0, 0.0f);
      const bool resolved = cnt[j] < 0 || live;
      fp_reply(io, b, r[j], row, resolved, cnt[j]);
      if (io.bits != nullptr) {
        put_bit(io.bits, r[j], row.granted > 0);
        put_bit(io.bits + io.plane, r[j], resolved);
      }
      if (live) P::commit(T, s[j], sl, now, row.used);
    }
    return;
  }
  using Scan = typename Blk::Scan;
  uint32_t k[kIpt];
  uint16_t pos[kIpt];
  bool head[kIpt];
  drl_batch::sort_repeats<kT, kIpt>(sh, rep, n_rep, k, pos, head);
  typename P::Slot sl[kIpt];
  drl::Seg seg[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int p = tid * kIpt + j;
    r[j] = row_at(pos[j]);
    cnt[j] = count_of(r[j]);
    s[j] = pos[j] < m ? shf.cell[pos[j]] : -1;
    sl[j] = typename P::Slot{};
    if (s[j] >= 0) sl[j] = P::advance(P::gather(T, s[j]), now, prm);
    seg[j] = drl::Seg{s[j] >= 0 ? (long long)cnt[j] : 0, head[j] ? p : -1};
  }
  Scan(sh.temp.scan).InclusiveScan(seg, seg, drl::SegSum());
  FlushRow row[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int p = tid * kIpt + j;
    const bool live = s[j] >= 0;
    const long long c = live ? cnt[j] : 0;
    row[j] = decide_one<P>(sl[j], live, now, prm, (int32_t)c,
                              __ll2float_rn(seg[j].sum - c));
    seg[j] = drl::Seg{row[j].used, head[j] ? p : -1};
  }
  __syncthreads();  // the scan's storage is used again
  Scan(sh.temp.scan).InclusiveScan(seg, seg, drl::SegSum());
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int p = tid * kIpt + j;
    if (r[j] >= b) continue;
    const bool resolved = cnt[j] < 0 || s[j] >= 0;
    fp_reply(io, b, r[j], row[j], resolved, cnt[j]);
    if (io.bits != nullptr) {
      put_bit(io.bits, r[j], row[j].granted > 0);
      put_bit(io.bits + io.plane, r[j], resolved);
    }
    if (s[j] >= 0 &&
        drl_batch::segment_tail<kT, kIpt>(sh, sh.key, k[j], n_rep, p)) {
      P::commit(T, s[j], sl[j], now, seg[j].sum);
    }
  }
}

template <class P, int kIpt>
int launch_fp_flush_block(typename P::Table T, const FpFlush& io, int32_t b,
                          typename P::Params prm, cudaStream_t stream) {
  constexpr int kT = 1024;
  constexpr size_t kSmem = sizeof(FpFlushShared<kT, kIpt>);
  static_assert(kSmem <= 232448, "fits in an SM's shared memory");
  if constexpr (kSmem > 48 * 1024) {
    static bool allowed[64] = {false};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !allowed[dev]) {
      err = cudaFuncSetAttribute(fp_flush_block_kernel<P, kT, kIpt>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) allowed[dev] = true;
    }
  }
  fp_flush_block_kernel<P, kT, kIpt>
      <<<drl_batch::launch_blocks(b), kT, kSmem, stream>>>(T, io, b, prm);
  return (int)cudaGetLastError();
}

// Scratch bytes of a fingerprint decision of K x B rows: none for the flush
// form; the scan form's operand (i32[2, K, B]: slots, then counts) and the
// scan's scratch after it.
inline int64_t fp_scratch_bytes(int32_t n_batches, int32_t b) {
  if (n_batches == 1 && b <= kFlushBlockRows) return 0;
  const int64_t rows = (int64_t)n_batches * b;
  return (int64_t)align16(8 * rows) + scan_scratch_bytes(n_batches, b);
}

// keys u32[K, B, 3]; nows_k i32[K]; exactly one of out (f32[K, 2, B]) and
// bits (u8[2, W], W the rows' 32-bit words x 4 bytes: the grant plane,
// then the resolve plane; B % 8 == 0) is non-null; counts (i32[B], K = 1
// only) may be null; scratch holds fp_scratch_bytes(K, B) bytes, and in the
// scan form its first 8 K B bytes are the operand, whose counts row the
// caller may read (i32[K, B] at byte 4 K B). The flush form is one launch;
// the scan form two, on one stream.
template <class P>
int launch_fp_decide(typename P::Table T, int32_t n_slots, void* cells,
                     int32_t L, int32_t shards, const uint32_t* keys,
                     const int32_t* nows_k, int32_t n_batches, int32_t b,
                     typename P::Params prm, float* out, uint8_t* bits,
                     int32_t* counts, void* scratch, cudaStream_t stream) {
  if (b <= 0 || n_batches <= 0) return (int)cudaSuccess;
  if (drl_fp::bad_table(n_slots, L, shards) || keys == nullptr ||
      nows_k == nullptr || (out == nullptr) == (bits == nullptr) ||
      (bits != nullptr && b % 8 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const drl_fp::Fp f = drl_fp::make_fp(cells, n_slots, L, shards);
  const int64_t rows = (int64_t)n_batches * b;
  const int32_t words = (int32_t)((rows + 31) / 32);
  if (n_batches == 1 && b <= kFlushBlockRows) {
    const FpFlush io{f, keys, nows_k, out, reinterpret_cast<uint32_t*>(bits),
                     words, counts};
    if (b <= drl_batch::kWarpRows) {
      const int rpw = 32 / f.group;
      fp_flush_warp_kernel<P><<<1, 32 * ((b + rpw - 1) / rpw), 0, stream>>>(
          T, io, b, prm);
      return (int)cudaGetLastError();
    }
    if (b <= 1024) return launch_fp_flush_block<P, 1>(T, io, b, prm, stream);
    if (b <= 2048) return launch_fp_flush_block<P, 2>(T, io, b, prm, stream);
    return launch_fp_flush_block<P, 4>(T, io, b, prm, stream);
  }
  if (scratch == nullptr || counts != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int32_t* op_rows = reinterpret_cast<int32_t*>(base);
  const int rc = drl_fp::launch_resolve(f, keys, 3, nullptr, rows, op_rows,
                                        kUnresolvedSlot, op_rows + rows,
                                        nullptr, stream);
  if (rc != 0) return rc;
  const ScanOp op{base, nullptr, nullptr, kOpI32, 0};
  return launch_scan<P, kFpOps>(
      T, n_slots, op, true, nows_k, n_batches, b, prm, out, bits,
      base + align16(8 * rows), stream,
      bits != nullptr ? reinterpret_cast<uint32_t*>(bits) + words : nullptr);
}

}  // namespace drl
