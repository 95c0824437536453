// One writer a slot for kernels whose rows reply from the state as it was
// before the launch and add a float to their slot: the counter sync
// (counter.cu: value = decayed + the slot's counts) and the tier-0 debit
// (admission.cu: tokens = refilled - the slot's applied amounts). Neither
// computes an in-kernel prefix (the debit's comes from the host), so rows
// need not talk to each other to reply; all that rows of one slot share is
// the write-back, which here has one writer that stores the slot's sum once.
//
// Policy P (a struct of the kernel's file):
//   P::Table                  the state pointers and sizes (by value; n)
//   P::kPadReadsSlot0         whether a padding row reads slot 0 for its
//                             reply (the sync: the JAX gather's clamp)
//   P::load(T, packed, b, i, g, reads) -> In   row i's operand (i >= 0)
//                             and, if `reads`, slot g's state: every load a
//                             row needs, issued together
//   P::advance(T, in, now) -> Row {base, aux, x, existed}   base is what
//                             the slot's sum starts from, aux what else its
//                             writer stores, existed the slot's flag
//   P::decide(T, in, b, i, valid, now, out) -> Row {base, aux, x}
//                             advance, then row i's reply into out[i],
//                             out[b + i]; x is what the row adds (0 for
//                             padding)
//   P::commit(T, s, value, aux, now, existed)   the slot's one writer (it
//                             stores exists only where it was clear)
//
// The sum. A slot's value is base + the sum of its rows' x, rounded ONCE to
// float32 (Exact, below): every x is a float32, so it is an integer multiple
// of 2^-149 below 2^128, and 9 int64 limbs of 32 bits each hold the exact
// sum of fewer than 2^31 of them (any int32 B) with room for the carries: a
// row adds less than 2^32 to a limb. A row adds its x to
// two limbs; the sum does not depend on the order of the adds, so the table
// is deterministic without placing a slot's rows in a fixed order first
// (the scan's placement and walk, decide.cuh, are not needed: there is no
// chain). The plain version adds row by row, rounding each add: where every
// partial sum is exact in float32 (whole numbers below 2^24) it rounds
// nothing and equals this; otherwise r rounded adds lie within r/2 spacings
// of the exact sum and this within 1/2. Infinities and NaN are flags: NaN,
// or both infinities, give NaN; one infinity gives it.
//
// Paths, chosen on the host by B:
//   - B <= 32: one warp, row = lane; __match_any_sync finds a row's peers
//     and the highest peer writes, adding its peers' x to base one float
//     add at a time in lane order: the plain version's order, so equal to
//     it bit for bit on every input. No barrier, no scratch.
//   - 33 <= B <= 4096: blocks sized by the rows, above 256 rows min(64, B /
//     64) of them by a hash of the slot (batch.cuh's launch_blocks and
//     own_rows), so that all rows of a slot meet in one block; a padding
//     row that reads slot 0 goes to slot 0's block, so that it reads slot 0
//     before that block writes it. A hash set in shared memory counts each
//     slot's rows; a batch without repeats commits at once. Otherwise each
//     repeated slot takes an Exact record in shared memory (over the set,
//     which is dead by then), its rows add to it with 32-bit shared-memory
//     atomics, and the row that claimed the entry commits.
//   - B > 4096 (the fleet sync, the tier-0 debit, the approximate path's
//     rounds): every SM in one cooperative launch (the grid sized from the
//     occupancy calculator), over claim entries (below). Pass 1: each row
//     claims its slot's entry (one compare-and-swap a slot a warp); the one
//     row that marks the slot repeated takes an Exact record. A grid
//     barrier. Pass 2: each slot's first row reads the slot and replies;
//     the other rows of a repeated slot reply and add their x to its record
//     (the lanes of a record in a warp summed with 32-bit warp reductions
//     first: one atomic a limb a warp, not a serial walk). Dense, the first
//     rows are found by walking the entries in slot order, so that
//     neighbouring slots share the state's sectors, and a slot seen once
//     commits at once: without repeats the launch ends there, after one
//     barrier. Hashed, the first rows come from the rows and a slot seen
//     once stages its value. A second barrier; pass 3 commits the staged
//     slots, and gathers each repeated slot again (nothing has written it)
//     and commits it.
//
// The claim entries: 32-bit, zeroed by the wrapper before each launch (one
// fill; on the H100 it cost less than emptying each claimed entry in the
// kernel for the next launch), so no pass clears them and a claim is one
// compare-and-swap against zero. Dense (a table of at most two slots a row, the fleet sync,
// or one past the L2 with at most 32 slots a row, the tier-0 debit's 2^20
// keys of 2^24 slots), claim[1 + s] is slot s's: its first row + 1; the
// walk in slot order is what makes the dense path pay: on the H100, 2^20
// distinct slots of a 2^24 table decided row by row were slower than a
// three-phase kernel, and in slot order faster. Hashed (a table in
// the L2 with more slots than two a row, the approximate path's Zipf
// rounds, or a sparse one), the entries are a set of 2^k >= 2B (slot + 1)
// by linear probing, which the L2 holds. Either sets its top bit once a
// second row joins. Two structures without the walk were slower on the
// H100 than a three-phase kernel (gather, set every duplicate, add with
// float atomics) at 2^20 rows: words tagged with a per-launch epoch, which
// need no emptying but a load before each compare-and-swap, and a hash set
// at load <= 1/4 cleared every launch behind a grid barrier.
//
// Traps, each with a test: every lane reaches every warp collective (a
// padding lane carries kEmptyKey); a row that is not its slot's writer
// never reads the slot after the writer may have written it (the warp
// path's __syncwarp, the block path's barriers, the grid path's first
// barrier; slot 0 for the sync's padding rows); no state pointer is const
// __restrict__ or read through __ldg, and what other blocks wrote before a
// grid barrier is read with __ldcg.

#pragma once

#include <cooperative_groups.h>

#include "batch.cuh"

namespace drl_tally {

namespace cg = cooperative_groups;
using drl::kEmptyKey;
using drl::kFullMask;

// ---------------------------------------------------------------------------
// Exact: a float32 sum rounded once.

constexpr int kLimbs = 9;
// A record in global memory (the grid path): the limbs, then its claim
// entry << 32 | the flags.
constexpr int kRecWords = kLimbs + 1;
constexpr unsigned kPosInf = 1, kNegInf = 2, kNaN = 4;

// x = m * 2^(o - 149) with m < 2^24 and 0 <= o <= 253: m << (o % 32) spans
// limbs k = o / 32 (its low 32 bits, lo) and k + 1 (the rest, hi), signed.
// An infinity or NaN sets a flag instead.
struct Piece {
  int k;
  long long lo, hi;
  unsigned flag;
};

__device__ __forceinline__ Piece split(float x) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t e = (u >> 23) & 0xFFu;
  const uint32_t f = u & 0x7FFFFFu;
  if (e == 0xFFu) {
    return Piece{0, 0, 0, f != 0 ? kNaN : (u >> 31) ? kNegInf : kPosInf};
  }
  const int o = e != 0 ? (int)e - 1 : 0;
  const unsigned long long v =
      (unsigned long long)(e != 0 ? (f | 0x800000u) : f) << (o & 31);
  long long lo = (long long)(v & 0xFFFFFFFFull), hi = (long long)(v >> 32);
  if (u >> 31) {
    lo = -lo;
    hi = -hi;
  }
  return Piece{o >> 5, lo, hi, 0};
}

struct Exact {
  long long limb[kLimbs];
  unsigned flags;

  __device__ __forceinline__ void add(float x) {
    const Piece p = split(x);
    flags |= p.flag;
#pragma unroll
    for (int j = 0; j + 1 < kLimbs; ++j) {  // indexed in registers
      if (j == p.k) {
        limb[j] += p.lo;
        limb[j + 1] += p.hi;
      }
    }
  }
  // The sum rounded to nearest even (+0 if it is 0). Consumes the limbs.
  __device__ float round() {
    if ((flags & kNaN) || (flags & (kPosInf | kNegInf)) ==
                              (kPosInf | kNegInf)) {
      return __int_as_float(0x7FC00000);
    }
    if (flags & kPosInf) return __int_as_float(0x7F800000);
    if (flags & kNegInf) return __int_as_float((int)0xFF800000u);
    carry();
    const bool neg = limb[kLimbs - 1] < 0;
    if (neg) {
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) limb[j] = -limb[j];
      carry();
    }
    // The magnitude as 32-bit digits (the top limb holds up to 55 bits).
    uint32_t d[kLimbs + 1];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) d[j] = (uint32_t)limb[j];
    d[kLimbs] = (uint32_t)(limb[kLimbs - 1] >> 32);
    int top = -1;
#pragma unroll
    for (int j = 0; j <= kLimbs; ++j) {
      if (d[j] != 0) top = 32 * j + 31 - __clz(d[j]);
    }
    if (top < 0) return 0.0f;
    // The 64 bits below and at the top bit, and whether any bit below them
    // is set: converted with one rounding, then scaled by a power of two
    // (exact: a subnormal sum has fewer than 24 bits, all in the window).
    const int lo = top - 63;
    unsigned long long w = 0;
    bool sticky = false;
#pragma unroll
    for (int j = 0; j <= kLimbs; ++j) {
      const int sh = 32 * j - lo;
      const unsigned long long dj = d[j];
      if (sh >= 64) continue;
      if (sh >= 0) {
        w |= dj << sh;
      } else if (sh > -32) {
        w |= dj >> -sh;
        sticky |= (dj & ((1ull << -sh) - 1)) != 0;
      } else {
        sticky |= dj != 0;
      }
    }
    const float r = ldexpf(__ull2float_rn(w | (sticky ? 1ull : 0ull)),
                           lo - 149);
    return neg ? -r : r;
  }

 private:
  // Limbs 0 .. kLimbs - 2 into [0, 2^32), the sign in the top limb.
  __device__ __forceinline__ void carry() {
#pragma unroll
    for (int j = 0; j + 1 < kLimbs; ++j) {
      const long long c = limb[j] >> 32;  // arithmetic: floor
      limb[j] &= 0xFFFFFFFFll;
      limb[j + 1] += c;
    }
  }
};

// A record in global memory as an Exact (read after the barrier that
// follows its last add: through the L2).
__device__ __forceinline__ Exact read_record(const unsigned long long* rec) {
  Exact a;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) a.limb[j] = (long long)__ldcg(&rec[j]);
  a.flags = (unsigned)(__ldcg(&rec[kLimbs]) & 0xFFFFFFFFull);
  return a;
}

// One row's x into a record in global memory: two limbs, or a flag.
__device__ __forceinline__ void add_x(unsigned long long* rec, float x) {
  const Piece p = split(x);
  if (p.flag != 0) {
    atomicOr(&rec[kLimbs], (unsigned long long)p.flag);
    return;
  }
  if (p.lo != 0) atomicAdd(&rec[p.k], (unsigned long long)p.lo);
  if (p.hi != 0) atomicAdd(&rec[p.k + 1], (unsigned long long)p.hi);
}

// The block path's record in shared memory, in 32-bit words, so that every
// row adds with native 32-bit shared atomics: per limb j, the sum of its
// contributions' low 16 bits (word j, unsigned) and of the rest (word
// kLimbs + j, signed); the flags last. A block's 4096 rows keep both
// within 32 bits.
constexpr int kRec32Words = 2 * kLimbs + 1;

__device__ __forceinline__ void add_x32(uint32_t* rec, float x) {
  const Piece p = split(x);
  if (p.flag != 0) {
    atomicOr(&rec[2 * kLimbs], p.flag);
    return;
  }
  if (p.lo != 0) {
    atomicAdd(&rec[p.k], (uint32_t)(p.lo & 0xFFFF));
    atomicAdd(reinterpret_cast<int*>(&rec[kLimbs + p.k]), (int)(p.lo >> 16));
  }
  if (p.hi != 0) {
    atomicAdd(&rec[p.k + 1], (uint32_t)(p.hi & 0xFFFF));
    atomicAdd(reinterpret_cast<int*>(&rec[kLimbs + p.k + 1]),
              (int)(p.hi >> 16));
  }
}

__device__ __forceinline__ Exact read_record32(const uint32_t* rec) {
  Exact a;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    a.limb[j] = (long long)rec[j] + ((long long)(int)rec[kLimbs + j] << 16);
  }
  a.flags = rec[2 * kLimbs];
  return a;
}

// The lanes of `peers` (a __match_any_sync group; every one of them calls
// this) add their x to rec together: per limb, the group's contributions
// are summed with 32-bit warp reductions (a contribution c, |c| < 2^32, as
// its low 16 bits plus c >> 16, so that 32 of each fit), and the lowest
// lane adds each nonzero limb with one atomic. A hot slot's rows thus cost
// an atomic a limb a warp, not one a row.
__device__ __forceinline__ void add_group(unsigned long long* rec,
                                          unsigned peers, float x) {
  const Piece p = split(x);
  const unsigned flags = __reduce_or_sync(peers, p.flag);
  const int k0 = (int)__reduce_min_sync(peers, (unsigned)p.k);
  const int k1 = (int)__reduce_max_sync(peers, (unsigned)p.k) + 1;
  const bool lead = (int)(threadIdx.x & 31) == __ffs(peers) - 1;
  for (int j = k0; j <= k1; ++j) {  // the same bounds in the group
    const long long c = p.k == j ? p.lo : p.k + 1 == j ? p.hi : 0;
    const unsigned lo16 = __reduce_add_sync(peers, (unsigned)(c & 0xFFFF));
    const int hi = __reduce_add_sync(peers, (int)(c >> 16));
    const long long sum = (long long)lo16 + ((long long)hi << 16);
    if (lead && sum != 0) atomicAdd(&rec[j], (unsigned long long)sum);
  }
  if (lead && flags != 0) atomicOr(&rec[kLimbs], (unsigned long long)flags);
}

// Row i's loads (its operand, and the state of the slot it reads) and its
// decision, for a row of slot s: a valid row reads its slot, a padding row
// slot 0 if the policy's padding replies from it, else nothing.
template <class P>
__device__ __forceinline__ typename P::In load_row(const typename P::Table& T,
                                                   const int32_t* packed,
                                                   int32_t b, int64_t i,
                                                   int32_t s, bool valid) {
  return P::load(T, packed, b, i, valid ? s : 0,
                 valid || P::kPadReadsSlot0);
}

// ---------------------------------------------------------------------------
// B <= 32: one warp, row = lane.

template <class P>
__global__ void __launch_bounds__(32, 1)
    tally_warp_kernel(typename P::Table T, const int32_t* __restrict__ packed,
                      int32_t b, float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int32_t now = packed[2 * b];
  const int32_t s = lane < b ? packed[lane] : -1;
  const bool valid = s >= 0 && s < T.n;
  typename P::Row row{0.0f, 0.0f, 0.0f, false};
  if (lane < b) {
    row = P::decide(T, load_row<P>(T, packed, b, lane, s, valid), b, lane,
                    valid, now, out);
  }
  const unsigned me = 1u << lane;
  const unsigned peers =
      __match_any_sync(kFullMask, valid ? (uint32_t)s : kEmptyKey);
  const bool writer = valid && lane == 31 - __clz(peers);
  float value = __fadd_rn(row.base, row.x);
  if (!__all_sync(kFullMask, !valid || peers == me)) {
    __shared__ float buf[32];
    buf[lane] = row.x;
    __syncwarp();
    if (writer) {  // the peers' adds one at a time, in lane order
      value = row.base;
      for (unsigned m = peers; m != 0; m &= m - 1) {
        value = __fadd_rn(value, buf[__ffs(m) - 1]);
      }
    }
  }
  __syncwarp();  // every row has read its slot
  if (writer) P::commit(T, s, value, row.aux, now, row.existed);
}

// ---------------------------------------------------------------------------
// 33 <= B <= 4096: blocks sized by the rows.

template <int kT, int kIpt>
struct BlockShared {
  using Blk = drl_batch::Block<kT, kIpt>;
  static constexpr int kRows = kT * kIpt;
  typename Blk::Count::TempStorage count;  // own_rows'
  uint16_t sub[kRows];  // several blocks: the block's rows, in order
  int32_t n_rep;        // records taken
  union {
    struct {
      alignas(16) uint32_t hkey[Blk::kHash];  // an entry's slot
      alignas(16) uint32_t hval[Blk::kHash];  // its rows, then its record
    } set;
    // At most one record per two rows: the repeated slots' sums.
    uint32_t rec[kRows / 2][kRec32Words];
  } u;
};

// The block's rows are positions i = j * kT + threadIdx.x < m, in request
// order (a block's rows spread over all its warps first, as the flush's).
template <class P, int kT, int kIpt>
__global__ void __launch_bounds__(kT, 1)
    tally_block_kernel(typename P::Table T,
                       const int32_t* __restrict__ packed, int32_t b,
                       float* __restrict__ out) {
  using Sh = BlockShared<kT, kIpt>;
  extern __shared__ __align__(16) unsigned char smem[];
  Sh& sh = *reinterpret_cast<Sh*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool all = gridDim.x == 1;
  const int32_t now = packed[2 * b];
  auto slot_of = [&](int r) { return r < b ? packed[r] : -1; };
  uint32_t key[kIpt];
  if (!all) {  // the partition's key: the slot, or 0 for a row reading it
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      const int r = tid * kIpt + j;
      const int32_t s = slot_of(r);
      key[j] = s >= 0 && s < T.n ? (uint32_t)s
               : r < b && P::kPadReadsSlot0 ? 0u
                                            : kEmptyKey;
    }
  }
  const int m =
      drl_batch::own_rows<kT, kIpt>(sh.count, sh.sub, b, all, key);
  if (m == 0) return;  // none of the batch's slots is this block's
  // Row steps j whose positions of this warp all lie at or past m are idle
  // (warp-uniform; every later step too).
  const int steps = (m - (tid & ~31) + kT - 1) / kT;

  // 1. Each row reads its slot (every load in flight at once) and replies;
  //    the set is emptied meanwhile.
  int r[kIpt];
  int32_t s[kIpt];
  bool valid[kIpt];
  typename P::In in[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int i = j * kT + tid;
    r[j] = i >= m ? b : all ? i : (int)sh.sub[i];
    s[j] = slot_of(r[j]);
    valid[j] = s[j] >= 0 && s[j] < T.n;
    if (r[j] < b) in[j] = load_row<P>(T, packed, b, r[j], s[j], valid[j]);
  }
  typename P::Row row[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    row[j] = typename P::Row{0.0f, 0.0f, 0.0f, false};
    if (r[j] < b) row[j] = P::decide(T, in[j], b, r[j], valid[j], now, out);
  }
  const int bits = drl_batch::hash_bits(m);
  for (int i = tid; i < (1 << bits) / 4; i += kT) {
    reinterpret_cast<uint4*>(sh.u.set.hkey)[i] =
        make_uint4(kEmptyKey, kEmptyKey, kEmptyKey, kEmptyKey);
    reinterpret_cast<uint4*>(sh.u.set.hval)[i] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) sh.n_rep = 0;
  __syncthreads();

  // 2. Count each slot's rows (the lanes of a slot in a warp together); the
  //    lane that claims the entry owns the slot.
  int32_t e[kIpt];
  bool owner[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    e[j] = -1;
    owner[j] = false;
    if (j < steps) {
      const uint32_t k = valid[j] ? (uint32_t)s[j] : kEmptyKey;
      const unsigned peers = __match_any_sync(kFullMask, k);
      const int leader = __ffs(peers) - 1;
      int32_t h = -1;
      if (k != kEmptyKey && lane == leader) {
        h = (int32_t)drl_batch::set_entry(sh.u.set.hkey, bits, k, owner[j]);
        atomicAdd(&sh.u.set.hval[h], (uint32_t)__popc(peers));
      }
      e[j] = __shfl_sync(kFullMask, h, leader);
    }
  }
  __syncthreads();
  uint32_t cnt[kIpt];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    cnt[j] = e[j] >= 0 ? sh.u.set.hval[e[j]] : 0;
    any |= cnt[j] > 1;
  }
  // 3. A slot seen once commits now (every row has read its slot); a batch
  //    without repeats ends here. Each repeated slot's owner takes a record
  //    and leaves its number in the entry, over the count every row read.
  const bool repeats = __syncthreads_or(any);
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    if (cnt[j] == 1) {
      P::commit(T, s[j], __fadd_rn(row[j].base, row[j].x), row[j].aux, now,
                row[j].existed);
    }
  }
  if (!repeats) return;
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    if (j < steps) {
      const bool take = owner[j] && cnt[j] > 1;
      const unsigned took = __ballot_sync(kFullMask, take);
      int32_t base = 0;
      if (lane == 0 && took != 0) base = atomicAdd(&sh.n_rep, __popc(took));
      base = __shfl_sync(kFullMask, base, 0);
      if (take) {
        sh.u.set.hval[e[j]] =
            (uint32_t)(base + __popc(took & ((1u << lane) - 1)));
      }
    }
  }
  __syncthreads();
  int32_t d[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    d[j] = cnt[j] > 1 ? (int32_t)sh.u.set.hval[e[j]] : -1;
  }
  __syncthreads();  // the set is dead: its memory holds the records
  for (int i = tid; i < sh.n_rep * kRec32Words; i += kT) {
    (&sh.u.rec[0][0])[i] = 0;
  }
  __syncthreads();

  // 4. Each repeated slot's rows add their x to its record.
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    if (d[j] >= 0) add_x32(sh.u.rec[d[j]], row[j].x);
  }
  __syncthreads();

  // 5. Each repeated slot's owner commits base + its rows' sum.
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    if (owner[j] && cnt[j] > 1) {
      Exact a = read_record32(sh.u.rec[d[j]]);
      a.add(row[j].base);
      P::commit(T, s[j], a.round(), row[j].aux, now, row[j].existed);
    }
  }
}

template <class P, int kT, int kIpt>
int launch_block(typename P::Table T, const int32_t* packed, int32_t b,
                 float* out, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(BlockShared<kT, kIpt>);
  static_assert(kSmem <= 232448, "fits in an SM's shared memory");
  if constexpr (kSmem > 48 * 1024) {
    // Past 48 KB of dynamic shared memory the kernel must be allowed it:
    // once per device, not per launch.
    static bool allowed[64] = {false};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !allowed[dev]) {
      err = cudaFuncSetAttribute(tally_block_kernel<P, kT, kIpt>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) allowed[dev] = true;
    }
  }
  tally_block_kernel<P, kT, kIpt>
      <<<drl_batch::launch_blocks(b), kT, kSmem, stream>>>(T, packed, b, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B > 4096: every SM, in one cooperative launch.

constexpr int32_t kBlockRows = 4096;  // past it, the grid path
constexpr int kGridThreads = 256;
// Words or rows a thread takes at once in a pass, its loads all in flight.
constexpr int kInFlight = 4;
// A padding row's stash (negative, so pass 3 skips it; pass 2 tells padding
// by its slot, so that a stash may name any of 2^31 entries, claimed or
// joined).
constexpr int32_t kPadRow = -1;
// A claim entry's flag: its slot has more than one row.
constexpr uint32_t kRepeated = 0x80000000u;

// Whether a launch of b rows on a table of n slots of P claims into
// direct-indexed words and walks them in slot order (dense), or into a hash
// set and walks its rows. Dense where the table holds at most two slots a
// row, or where it is larger than the L2 (its state then comes from device
// memory, and neighbouring slots share its sectors) and holds at most 32
// slots a row. Dense too where the set would not fit its 31-bit names: past
// 2^30 rows (2^k >= 2b entries), or a table of 2^31 slots or more (an entry
// holds slot + 1 below its flag). Host only: it reads the device's L2 size
// (cached).
template <class P>
bool dense(int64_t n, int32_t b) {
  if (b > (1 << 30) || n >= (int64_t(1) << 31)) return true;
  static int l2[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return n <= 2 * b;
  if (l2[dev] == 0 &&
      cudaDeviceGetAttribute(&l2[dev], cudaDevAttrL2CacheSize, dev) !=
          cudaSuccess) {
    return n <= 2 * (int64_t)b;
  }
  return n <= 2 * (int64_t)b ||
         (n * P::kSlotBytes > (int64_t)l2[dev] && n <= 32 * (int64_t)b);
}

// Bits of the hash set of a launch of b rows: 2^bits >= 2b entries.
__host__ __device__ inline int hash_bits(int32_t b) {
  int bits = 6;
  while ((int64_t(1) << bits) < 2 * (int64_t)b) ++bits;
  return bits;
}

// Claim entries a launch uses: a word a slot, or the hash set's.
__host__ __device__ inline int64_t claim_entries(int64_t n, int32_t b,
                                                 bool hash) {
  return hash ? int64_t(1) << hash_bits(b) : n;
}

// The grid path's scratch: the records (at most one per two rows); per row
// its stash (its claim entry e if it claimed it, ~e if it joined it,
// kPadRow for padding) and, hashed, what a slot seen once commits (value,
// aux, and whether it existed); per claim entry the record of a repeated
// slot.
struct GridScratch {
  unsigned long long* rec;
  int32_t* stash;
  float2* stage;
  uint8_t* existed;
  uint32_t* recno;
};

__host__ __device__ inline GridScratch grid_scratch(void* base, int64_t n,
                                                    int32_t b, bool hash,
                                                    size_t* bytes) {
  auto align16 = [](size_t x) { return (x + 15) & ~static_cast<size_t>(15); };
  unsigned char* p = static_cast<unsigned char*>(base);
  size_t o = 0;
  auto take = [&](size_t m) {
    unsigned char* q = p == nullptr ? nullptr : p + o;
    o += align16(m);
    return q;
  };
  GridScratch S;
  S.rec = reinterpret_cast<unsigned long long*>(
      take(8 * kRecWords * ((size_t)b / 2 + 1)));
  S.stash = reinterpret_cast<int32_t*>(take(4 * (size_t)b));
  S.stage = reinterpret_cast<float2*>(take(hash ? 8 * (size_t)b : 0));
  S.existed = take(hash ? (size_t)b : 0);
  S.recno =
      reinterpret_cast<uint32_t*>(take(4 * (size_t)claim_entries(n, b, hash)));
  if (bytes != nullptr) *bytes = o;
  return S;
}

// claim: claim[0] the record counter, claim[1 + e] the entries, 32 bits:
// direct, e = s and its first row + 1; hashed, e from linear probing and
// s + 1; either with kRepeated once a second row joins. All zero at
// launch.
template <class P>
__global__ void __launch_bounds__(kGridThreads)
    tally_grid_kernel(typename P::Table T, const int32_t* __restrict__ packed,
                      int32_t b, float* __restrict__ out, uint32_t* claim,
                      bool hash, void* scratch) {
  const GridScratch S = grid_scratch(scratch, T.n, b, hash, nullptr);
  uint32_t* const counter = claim;
  uint32_t* const entry = claim + 1;
  const int lane = threadIdx.x & 31;
  const int64_t gtid = (int64_t)blockIdx.x * kGridThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kGridThreads;
  const int32_t now = packed[2 * (int64_t)b];
  const int hbits = hash_bits(b);
  constexpr int kR = kInFlight;

  // 1. Each valid row claims its slot's entry (the lanes of a slot in a
  //    warp together); the first claim fills it. The one row that marks the
  //    slot repeated (a first claim of several lanes, or the first to join
  //    a claim of one) takes a record, empties it and leaves its number at
  //    the entry. A padding row replies (the sync's from slot 0, before any
  //    write).
  for (int64_t w0 = gtid - lane; w0 < b; w0 += stride) {
    const int64_t i = w0 + lane;
    const int32_t s = i < b ? packed[i] : -1;
    const bool valid = s >= 0 && s < T.n;
    if (!valid && i < b) {
      P::decide(T, load_row<P>(T, packed, b, i, s, false), b, i, false, now,
                out);
    }
    const unsigned peers =
        __match_any_sync(kFullMask, valid ? (uint32_t)s : kEmptyKey);
    const int leader = __ffs(peers) - 1;
    int32_t st = kPadRow;
    if (valid && lane == leader) {
      const uint32_t many = __popc(peers) > 1 ? kRepeated : 0u;
      int64_t e = s;
      uint32_t old = 0;
      if (hash) {
        const uint32_t mine = (uint32_t)s + 1;
        e = ((uint32_t)s * 2654435761u) >> (32 - hbits);
        for (;;) {
          old = atomicCAS(&entry[e], 0u, mine | many);
          if (old == 0 || (old & ~kRepeated) == mine) break;
          e = (e + 1) & ((int64_t(1) << hbits) - 1);
        }
      } else {
        old = atomicCAS(&entry[e], 0u, ((uint32_t)i + 1) | many);
      }
      // Whether this claim marked the slot repeated: only one does.
      bool marked = old == 0 && many != 0;
      if (old != 0 && (old & kRepeated) == 0) {
        marked = (atomicOr(&entry[e], kRepeated) & kRepeated) == 0;
      }
      if (marked) {
        const uint32_t d = atomicAdd(counter, 1u);
        unsigned long long* rec = S.rec + (size_t)d * kRecWords;
#pragma unroll
        for (int q = 0; q < kLimbs; ++q) rec[q] = 0;
        rec[kLimbs] = (unsigned long long)e << 32;
        S.recno[e] = d;
      }
      st = old == 0 ? (int32_t)e : ~(int32_t)e;
    }
    const int32_t lst = __shfl_sync(kFullMask, st, leader);
    // The leader's own stash; its peers joined the entry.
    if (i < b) {
      S.stash[i] = !valid ? kPadRow : lane == leader ? st
                   : lst >= 0 ? ~lst : lst;
    }
  }
  cg::this_grid().sync();
  const uint32_t n_rec = __ldcg(counter);

  // 2. Each slot's first row reads the slot and replies; a repeated one's
  //    adds its x to the record. Dense, the first rows come from the words
  //    in slot order (the state's sectors shared by neighbouring slots), and
  //    a slot seen once commits at once; without
  //    repeats the launch ends here, after one barrier. Hashed, the first
  //    rows come from the rows, and a slot seen once stages its value for
  //    pass 3, so that this pass only reads the table and pass 3 only
  //    writes it. Every other row of a repeated slot reads it, replies and
  //    adds its x.
  auto first_row = [&](const typename P::In& in, int32_t s, int64_t i,
                       int64_t e, uint32_t w) {
    const typename P::Row r = P::decide(T, in, b, i, true, now, out);
    if (w & kRepeated) {
      add_x(S.rec + (size_t)__ldcg(&S.recno[e]) * kRecWords, r.x);
      if (hash) S.stash[i] = ~(int32_t)e;  // pass 3 skips it
    } else if (hash) {
      S.stage[i] = make_float2(__fadd_rn(r.base, r.x), r.aux);
      S.existed[i] = r.existed;
    } else {
      P::commit(T, s, __fadd_rn(r.base, r.x), r.aux, now, r.existed);
    }
  };
  if (!hash) {
    for (int64_t s0 = gtid; s0 < T.n; s0 += kR * stride) {
      uint32_t w[kR];
      typename P::In in[kR];
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int64_t s = s0 + q * stride;
        w[q] = s < T.n ? __ldcg(&entry[s]) : 0;
      }
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        if (w[q] != 0) {
          in[q] = P::load(T, packed, b, (int64_t)(w[q] & ~kRepeated) - 1,
                          s0 + q * stride, true);
        }
      }
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        if (w[q] != 0) {
          const int64_t s = s0 + q * stride;
          first_row(in[q], (int32_t)s, (int64_t)(w[q] & ~kRepeated) - 1, s,
                    w[q]);
        }
      }
    }
  }
  if (hash || n_rec > 0) {
    for (int64_t w0 = gtid - lane; w0 < b; w0 += kR * stride) {
      int32_t st[kR], s[kR];
      bool live[kR];
      uint32_t w[kR];
      typename P::In in[kR];
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int64_t i = w0 + q * stride + lane;
        s[q] = i < b ? packed[i] : -1;
        live[q] = s[q] >= 0 && s[q] < T.n;  // padding replied in pass 1
        st[q] = live[q] ? S.stash[i] : kPadRow;
        live[q] = live[q] && (hash || st[q] < 0);  // the walk took it
      }
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int64_t i = w0 + q * stride + lane;
        w[q] = live[q] && st[q] >= 0 ? __ldcg(&entry[st[q]]) : 0;
        if (live[q]) in[q] = P::load(T, packed, b, i, s[q], true);
      }
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        if (w0 + q * stride >= b) break;  // warp-uniform
        const int64_t i = w0 + q * stride + lane;
        if (live[q] && st[q] >= 0) first_row(in[q], s[q], i, st[q], w[q]);
        int32_t d = -1;
        float x = 0.0f;
        if (live[q] && st[q] < 0) {
          x = P::decide(T, in[q], b, i, true, now, out).x;
          d = (int32_t)__ldcg(&S.recno[~st[q]]);
        }
        if (n_rec > 0) {
          const unsigned peers = __match_any_sync(
              kFullMask, d >= 0 ? (uint32_t)d : kEmptyKey);
          if (d >= 0) add_group(S.rec + (size_t)d * kRecWords, peers, x);
        }
      }
    }
  }
  if (!hash && n_rec == 0) return;
  cg::this_grid().sync();

  // 3. Hashed, each slot seen once commits what its first row staged. Each
  //    repeated slot, once: gathered again (nothing has written it) and
  //    committed with base + its rows' sum.
  if (hash) {
    for (int64_t i = gtid; i < b; i += stride) {
      const int32_t st = S.stash[i];
      if (st < 0) continue;
      const float2 v = S.stage[i];
      P::commit(T, packed[i], v.x, v.y, now, S.existed[i] != 0);
    }
  }
  for (int64_t d = gtid; d < n_rec; d += stride) {
    const unsigned long long* rec = S.rec + (size_t)d * kRecWords;
    Exact a = read_record(rec);
    const int64_t e = (int64_t)(__ldcg(&rec[kLimbs]) >> 32);
    const int32_t s = hash ? (int32_t)(__ldcg(&entry[e]) & ~kRepeated) - 1
                           : (int32_t)e;
    const typename P::Row g =
        P::advance(T, P::load(T, packed, b, -1, s, true), now);
    a.add(g.base);
    P::commit(T, s, a.round(), g.aux, now, g.existed);
  }
}

// Resident blocks of the grid kernel on the current device (a cooperative
// grid may hold no more), cached per device.
template <class P>
int grid_limit(int* limit) {
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
      &per_sm, tally_grid_kernel<P>, kGridThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *limit = sms * per_sm;
  if (dev < 64) cached[dev] = *limit;
  return 0;
}

// Int32 claim words a launch of b rows on n slots of P takes (a counter
// and its entries), and bytes of scratch (none at b <= kBlockRows). Host.
template <class P>
int64_t claim_words(int64_t n, int32_t b) {
  return b <= kBlockRows ? 0 : 1 + claim_entries(n, b, !dense<P>(n, b));
}

template <class P>
int64_t scratch_bytes(int64_t n, int32_t b) {
  if (b <= kBlockRows) return 0;
  size_t bytes = 0;
  grid_scratch(nullptr, n, b, !dense<P>(n, b), &bytes);
  return (int64_t)bytes;
}

// One launch of b rows. Past kBlockRows rows: claim holds claim_words<P>(n,
// b) zero words, scratch scratch_bytes<P>(n, b) bytes.
template <class P>
int launch(typename P::Table T, const int32_t* packed, int32_t b, float* out,
           uint32_t* claim, void* scratch, cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (b <= drl_batch::kWarpRows) {
    tally_warp_kernel<P><<<1, 32, 0, stream>>>(T, packed, b, out);
    return (int)cudaGetLastError();
  }
  if (b <= 64) return launch_block<P, 64, 1>(T, packed, b, out, stream);
  if (b <= 256) return launch_block<P, 256, 1>(T, packed, b, out, stream);
  if (b <= 1024) return launch_block<P, 1024, 1>(T, packed, b, out, stream);
  if (b <= 2048) return launch_block<P, 1024, 2>(T, packed, b, out, stream);
  if (b <= kBlockRows) {
    return launch_block<P, 1024, 4>(T, packed, b, out, stream);
  }
  if (claim == nullptr || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  int limit = 0;
  const int rc = grid_limit<P>(&limit);
  if (rc != 0) return rc;
  if (limit <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  int64_t blocks = ((int64_t)b + kGridThreads - 1) / kGridThreads;
  if (blocks > limit) blocks = limit;
  bool hash = !dense<P>(T.n, b);
  void* args[] = {&T, (void*)&packed, &b, &out, &claim, &hash, &scratch};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)tally_grid_kernel<P>, dim3((unsigned)blocks),
      dim3(kGridThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace drl_tally
