// Two-level (tenant -> key) admission and the saturating bulk debit, for
// Hopper (sm_90a): one launch per call.
//
// Replaces (XLA programs of the JAX package, not Pallas kernels):
//   distributedratelimiting/redis_tpu/ops/kernels.py,
//     acquire_hierarchical_packed -> hier_warp_kernel (B <= 32) and
//     hier_block_kernel;
//   distributedratelimiting/redis_tpu/ops/kernels.py, debit_batch_packed
//     -> tally.cuh's warp, block and grid kernels with DebitPolicy.
//
// Both work on the token bucket's SoA table (tokens f32, last_ts i32, exists
// u8: 9 B a slot) and advance a slot with bucket.cuh's refill_or_init, the
// bucket kernels' own rounding.
//
// acquire_hierarchical, per row i < B of packed i32[4, B] (row 0 child
// slots, row 1 costs, row 2 the tick, column 0 read, row 3 parent slots; a
// row is valid only where BOTH slots lie in their tables, else it is
// padding):
//   c_ref, p_ref = the refilled child and parent buckets
//   c_pre = earlier valid rows' costs on the same child slot
//   child_ok = valid && c_ref >= c_pre + cost
//   p_pre = earlier valid rows' costs on the same parent slot, counting only
//           rows the child admitted
//   granted = child_ok && p_ref >= p_pre + cost
//   consumed = granted ? cost : 0
//   out[0][i] = granted
//   out[1][i] = valid ? min(max((c_ref - c_pre) - consumed, 0),
//                           max((p_ref - p_pre) - consumed, 0)) : 0
// and each valid row's child and parent slot: tokens = ref - the sum of the
// slot's granted consumption, last_ts = now, exists = 1 (both levels debit
// together or not at all; both timestamps advance either way).
// The parent prefix depends on the child decisions, which depend on the
// table, so the host cannot compute it. Prefixes are int64 sums converted
// once. Each slot of either table is written once, by one row, with the
// int64 sum of its consumption subtracted once: no atomics, and tokens are
// deterministic. They equal the plain version's row-by-row subtraction bit
// for bit wherever every partial sum is exact in float32 (whole costs,
// balances below 2^24), and lie within float rounding of it elsewhere.
//
// Design (batch.cuh): a launch costs what its rows need.
//   - B <= 32 (AdmissionPolicy.acquire, OP_ACQUIRE_H, most HBUCKET frames):
//     one warp. __match_any_sync on the child slot gives each row its
//     peers and c_pre (a sum over the lower-lane peers); the child decides;
//     the same on the parent slot with the child-admitted costs. The highest
//     lane of each peer set writes its slot with the set's consumption.
//   - 33 <= B <= 4096: blocks sized by B; above 256 rows min(64, B / 64)
//     of them, each deciding the rows of its share of the tenants, where
//     every key's rows lie under tenants of one block (the LLM workload's
//     keys are tenant-scoped); where a key's rows fall under two blocks, or
//     every row's tenant goes to one block (an HBUCKET frame of one
//     tenant), one block decides the batch. In a block, per level, a hash
//     set in shared memory finds the slots that repeat; a level without
//     repeats (distinct keys) has prefix 0 for every row and no sort.
//     Otherwise rows are sorted stably by the repeated slots' compact ids
//     (the LLM rows' 64 tenants: at most 7 bits, two passes) and one int64
//     segmented scan gives each row its prefix, which lands in shared
//     memory. After the decision a second scan in the same order sums
//     each slot's consumption, and the segment's last row writes the slot.
// Bound: bytes (the 16 B operand row and 8 B reply, 18 B per distinct slot
// of either table); at B = 4096 well under a microsecond, so a call costs
// its launch, its barriers and its scattered gathers and writes.
//
// debit_packed, per row i < B of packed i32[4, B] (row 0 slots, row 1 the
// float32 amounts bitcast, row 2 the tick, row 3 the float32 same-slot
// prefix of earlier amounts bitcast, computed on the host):
//   ref = refill_or_init(slot); avail = max(ref - pre, 0)
//   applied = min(amount, avail)   (a negative amount credits)
//   out[0][i] = avail - applied; out[1][i] = amount - applied   (valid rows;
//   padding rows 0, 0)
// and each slot of the valid rows, once: tokens = ref - the sum of its rows'
// applied amounts, last_ts = now, exists = 1 (the plain version sets every
// duplicate to ref, then subtracts row by row). Design (tally.cuh, with
// DebitPolicy below): a warp up to 32 rows, blocks sized by the rows up to
// 4096, every SM slot-major above (the store's 1M-key debit of distinct
// keys: one grid barrier). Each slot has one writer, which stores ref less
// its applied amounts rounded once (in lane order in the warp path): tokens
// are deterministic, equal to the plain version bit for bit wherever every
// partial sum is exact in float32 (whole amounts and balances below 2^24),
// and replies, last_ts and exists equal it always. Bound: memory; a row
// moves its 16 B operand and 8 B reply, and each distinct slot reads and
// writes its 9 B. What is reached at 2^20 distinct slots of a 2^24 table
// (144 MB, past the L2) is set by the state's scattered sectors, read and
// written back, not the 18 B a slot of the bound: the launch walks the
// claimed slots in slot order, so that neighbours share sectors, reads a
// missing slot's flag alone (it refills to cap), and stores exists only
// where it was clear.
// No state pointer is const __restrict__ or read through __ldg: the kernels
// write what they read.

#include "batch.cuh"
#include "bucket.cuh"
#include "tally.cuh"

namespace {

using drl::kEmptyKey;
using drl::kFullMask;
using drl_bucket::refill_or_init;

struct Table {
  float* tokens;
  int32_t* last_ts;
  uint8_t* exists;
  int32_t n;
  float cap;
  float rate;
};

__device__ __forceinline__ float refill(const Table& t, int32_t s,
                                        int32_t now) {
  return refill_or_init(t.tokens[s], t.last_ts[s], t.exists[s], now, t.cap,
                        t.rate);
}

// The slot's one writer: the refilled balance less the batch's consumption
// of the slot, applied once.
__device__ __forceinline__ void commit(const Table& t, int32_t s, float ref,
                                       long long used, int32_t now) {
  t.tokens[s] = __fsub_rn(ref, __ll2float_rn(used));
  t.last_ts[s] = now;
  t.exists[s] = 1;
}

// The row's reply: min(max((c_ref - c_pre) - consumed, 0),
// max((p_ref - p_pre) - consumed, 0)).
__device__ __forceinline__ float hier_remaining(float c_ref, float c_pre,
                                                float p_ref, float p_pre,
                                                float consumed) {
  return fminf(
      fmaxf(__fsub_rn(__fsub_rn(c_ref, c_pre), consumed), 0.0f),
      fmaxf(__fsub_rn(__fsub_rn(p_ref, p_pre), consumed), 0.0f));
}

// B <= 32: row = lane.
__global__ void __launch_bounds__(32, 1)
    hier_warp_kernel(Table C, Table P, const int32_t* __restrict__ packed,
                     int32_t b, float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int32_t now = packed[2 * b];
  const int32_t cs = lane < b ? packed[lane] : -1;
  const int32_t ps = lane < b ? packed[3 * b + lane] : -1;
  const int32_t cnt = lane < b ? packed[b + lane] : 0;
  const bool valid = cs >= 0 && cs < C.n && ps >= 0 && ps < P.n;
  float c_ref = 0.0f, p_ref = 0.0f;
  if (valid) {
    c_ref = refill(C, cs, now);
    p_ref = refill(P, ps, now);
  }
  const unsigned me = 1u << lane;
  const unsigned cpeers =
      __match_any_sync(kFullMask, valid ? (uint32_t)cs : kEmptyKey);
  const unsigned ppeers =
      __match_any_sync(kFullMask, valid ? (uint32_t)ps : kEmptyKey);
  const bool c_alone = __all_sync(kFullMask, !valid || cpeers == me);
  const bool p_alone = __all_sync(kFullMask, !valid || ppeers == me);
  // 1. Child prefix over every earlier same-key row; the child decides.
  long long c_pre = 0, unused = 0;
  if (!c_alone) {
    drl_batch::lane_sums(cpeers & (me - 1), 0, valid ? cnt : 0, b, c_pre,
                         unused);
  }
  const float c = __int2float_rn(cnt);
  const float c_pre_f = __ll2float_rn(c_pre);
  const bool child_ok = valid && c_ref >= __fadd_rn(c_pre_f, c);
  // 2. Parent prefix over the earlier same-tenant rows the child admitted.
  long long p_pre = 0;
  if (!p_alone) {
    drl_batch::lane_sums(ppeers & (me - 1), 0, child_ok ? cnt : 0, b, p_pre,
                         unused);
  }
  const float p_pre_f = __ll2float_rn(p_pre);
  const bool granted = child_ok && p_ref >= __fadd_rn(p_pre_f, c);
  const int32_t used = granted ? cnt : 0;
  if (lane < b) {
    out[lane] = granted ? 1.0f : 0.0f;
    out[b + lane] =
        valid ? hier_remaining(c_ref, c_pre_f, p_ref, p_pre_f,
                               granted ? c : 0.0f)
              : 0.0f;
  }
  // 3. Each slot's consumption, written once by its highest lane.
  long long c_used = used, p_used = used;
  if (!c_alone) drl_batch::lane_sums(0, cpeers, used, b, unused, c_used);
  if (!p_alone) drl_batch::lane_sums(0, ppeers, used, b, unused, p_used);
  __syncwarp();  // every row has read both slots
  if (!valid) return;
  if (lane == 31 - __clz(cpeers)) commit(C, cs, c_ref, c_used, now);
  if (lane == 31 - __clz(ppeers)) commit(P, ps, p_ref, p_used, now);
}

template <int kT, int kIpt>
struct HierShared {
  static constexpr int kRows = kT * kIpt;
  typename drl_batch::Block<kT, kIpt>::Shared batch;
  // By position: the level's demand, then each row's consumption; the
  // child prefix, then the refilled child; the parent's likewise.
  int32_t dem[kRows];
  float c_pre[kRows];
  float p_pre[kRows];
  // By sorted position: the child sort's keys and positions, and the
  // parent sort's positions (its keys stay in batch.key).
  uint32_t c_key[kRows];
  uint16_t c_pos[kRows];
  uint16_t p_pos[kRows];
};

// One level's prefix, where some slot repeats (n_rep > 0): sort the
// positions by repeated slot, scan sh.dem in that order and leave each
// position's exclusive prefix in pre; the sorted positions in spos and, if
// skey is given, the sorted keys there (else they stay in sh.batch.key).
template <int kT, int kIpt>
__device__ void level_prefix(HierShared<kT, kIpt>& sh,
                             const int32_t (&rep)[kIpt], int n_rep,
                             float* pre, uint16_t* spos, uint32_t* skey) {
  using Blk = drl_batch::Block<kT, kIpt>;
  const int tid = threadIdx.x;
  uint32_t k[kIpt];
  uint16_t pos[kIpt];
  bool head[kIpt];
  drl_batch::sort_repeats<kT, kIpt>(sh.batch, rep, n_rep, k, pos, head);
  drl::Seg seg[kIpt];
  int32_t d[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int p = tid * kIpt + j;
    d[j] = k[j] != (uint32_t)n_rep ? sh.dem[pos[j]] : 0;
    seg[j] = drl::Seg{d[j], head[j] ? p : -1};
    spos[p] = pos[j];
    if (skey != nullptr) skey[p] = k[j];
  }
  typename Blk::Scan(sh.batch.temp.scan).InclusiveScan(seg, seg,
                                                       drl::SegSum());
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    pre[pos[j]] = __ll2float_rn(seg[j].sum - d[j]);
  }
  __syncthreads();
}

// Write each slot of a level once, where the level had repeats: in its
// sorted order (skey, spos), each segment's last position writes the slot
// (slot[pos], kEmptyKey for padding) with its refilled value (ref[pos])
// less the segment's int64 sum of sh.dem (the rows' consumption).
template <int kT, int kIpt>
__device__ void commit_sorted(HierShared<kT, kIpt>& sh, const Table& t,
                              int n_rep, const uint32_t* skey,
                              const uint16_t* spos, const uint32_t* slot,
                              const float* ref, int32_t now) {
  using Blk = drl_batch::Block<kT, kIpt>;
  const int tid = threadIdx.x;
  drl::Seg seg[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int p = tid * kIpt + j;
    const bool head = skey[p] == (uint32_t)n_rep || p == 0 ||
                      skey[p - 1] != skey[p];
    seg[j] = drl::Seg{sh.dem[spos[p]], head ? p : -1};
  }
  __syncthreads();  // the scan's storage is free
  typename Blk::Scan(sh.batch.temp.scan).InclusiveScan(seg, seg,
                                                       drl::SegSum());
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int p = tid * kIpt + j;
    const int pos = spos[p];
    if (slot[pos] != kEmptyKey &&
        drl_batch::segment_tail<kT, kIpt>(sh.batch, skey, skey[p], n_rep,
                                           p)) {
      commit(t, (int32_t)slot[pos], ref[pos], seg[j].sum, now);
    }
  }
}

// 33 <= B <= kT x kIpt, on G blocks: each decides the rows of its share of
// the tenants (batch.cuh's own_rows on the parent slot), position i =
// threadIdx.x * kIpt + j of its m rows in request order. That needs every
// key's rows under one tenant's block; where a key's rows fall in two
// blocks (split_slots), or every row's tenant goes to one block
// (one_block: no set to fill), block 0 decides the whole batch and the
// others return (every block finds the same).
template <int kT, int kIpt>
__global__ void __launch_bounds__(kT, 1)
    hier_block_kernel(Table C, Table P, const int32_t* __restrict__ packed,
                      int32_t b, float* __restrict__ out) {
  using Sh = HierShared<kT, kIpt>;
  extern __shared__ __align__(16) unsigned char smem[];
  Sh& sh = *reinterpret_cast<Sh*>(smem);
  const int tid = threadIdx.x;
  const int32_t now = packed[2 * b];
  bool all = gridDim.x == 1;
  uint32_t key[kIpt];  // first every row's parent slot, then a level's
  if (!all) {
    uint32_t ckey[kIpt];
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      const int r = tid * kIpt + j;
      const int32_t cs = r < b ? packed[r] : -1;
      const int32_t ps = r < b ? packed[3 * b + r] : -1;
      const bool valid = cs >= 0 && cs < C.n && ps >= 0 && ps < P.n;
      ckey[j] = valid ? (uint32_t)cs : kEmptyKey;
      key[j] = valid ? (uint32_t)ps : kEmptyKey;
    }
    const int32_t c0 = packed[0], p0 = packed[3 * b];
    const bool valid0 = c0 >= 0 && c0 < C.n && p0 >= 0 && p0 < P.n;
    if (drl_batch::one_block<kIpt>(valid0 ? (uint32_t)p0 : kEmptyKey, key) ||
        drl_batch::split_slots<kT, kIpt>(sh.batch, b, ckey, key)) {
      if (blockIdx.x != 0) return;
      all = true;
    }
  }
  const int m = drl_batch::own_rows<kT, kIpt>(sh.batch.temp.count,
                                              sh.batch.sub, b, all, key);
  if (m == 0) return;  // none of the batch's slots is this block's
  auto row_at = [&](int i) {
    return i >= m ? b : all ? i : (int)sh.batch.sub[i];
  };

  // 1. Rows in request order; both refills in flight while the child set
  //    fills (every read of the state precedes the first write, which
  //    follows the parent level's barriers).
  int32_t r[kIpt], cs[kIpt], ps[kIpt], cnt[kIpt];
  bool valid[kIpt];
  float c_ref[kIpt], p_ref[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    r[j] = row_at(tid * kIpt + j);
    cs[j] = r[j] < b ? packed[r[j]] : -1;
    ps[j] = r[j] < b ? packed[3 * b + r[j]] : -1;
    cnt[j] = r[j] < b ? packed[b + r[j]] : 0;
    valid[j] = cs[j] >= 0 && cs[j] < C.n && ps[j] >= 0 && ps[j] < P.n;
    key[j] = valid[j] ? (uint32_t)cs[j] : kEmptyKey;
    c_ref[j] = valid[j] ? refill(C, cs[j], now) : 0.0f;
    p_ref[j] = valid[j] ? refill(P, ps[j], now) : 0.0f;
    sh.dem[tid * kIpt + j] = valid[j] ? cnt[j] : 0;
  }
  // 2. Child prefix over every earlier same-key row; the child decides.
  int32_t rep[kIpt];
  const int n_c = drl_batch::find_repeats<kT, kIpt>(sh.batch, m, key, rep);
  if (n_c > 0) {
    level_prefix<kT, kIpt>(sh, rep, n_c, sh.c_pre, sh.c_pos, sh.c_key);
  }
  float c_pre[kIpt];
  bool child_ok[kIpt];
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int i = tid * kIpt + j;
    c_pre[j] = n_c > 0 ? sh.c_pre[i] : 0.0f;
    child_ok[j] = valid[j] && c_ref[j] >= __fadd_rn(c_pre[j],
                                                    __int2float_rn(cnt[j]));
    sh.dem[i] = child_ok[j] ? cnt[j] : 0;
    key[j] = valid[j] ? (uint32_t)ps[j] : kEmptyKey;
  }
  // 3. Parent prefix over the earlier same-tenant rows the child admitted.
  const int n_p = drl_batch::find_repeats<kT, kIpt>(sh.batch, m, key, rep);
  if (n_p > 0) {
    level_prefix<kT, kIpt>(sh, rep, n_p, sh.p_pre, sh.p_pos, nullptr);
  }

  // 4. Decide and reply. Where a level has no repeats every valid row
  //    writes its own slot; else each row leaves, by position, its slot,
  //    its refilled value and its consumption for that level's commit.
  uint32_t* c_slot = sh.batch.hkey;  // the sets are free now
  uint32_t* p_slot = sh.batch.hval;
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int i = tid * kIpt + j;
    const float c = __int2float_rn(cnt[j]);
    const float p_pre = n_p > 0 ? sh.p_pre[i] : 0.0f;
    const bool granted = child_ok[j] && p_ref[j] >= __fadd_rn(p_pre, c);
    const int32_t used = granted ? cnt[j] : 0;
    if (r[j] < b) {
      out[r[j]] = granted ? 1.0f : 0.0f;
      out[b + r[j]] = valid[j] ? hier_remaining(c_ref[j], c_pre[j], p_ref[j],
                                                p_pre, granted ? c : 0.0f)
                               : 0.0f;
    }
    sh.dem[i] = used;
    c_slot[i] = valid[j] ? (uint32_t)cs[j] : kEmptyKey;
    p_slot[i] = valid[j] ? (uint32_t)ps[j] : kEmptyKey;
    sh.c_pre[i] = c_ref[j];
    sh.p_pre[i] = p_ref[j];
    if (valid[j] && n_c == 0) commit(C, cs[j], c_ref[j], used, now);
    if (valid[j] && n_p == 0) commit(P, ps[j], p_ref[j], used, now);
  }
  // 5. Each repeated level's slots, once each, in its sorted order.
  __syncthreads();
  if (n_c > 0) {
    commit_sorted<kT, kIpt>(sh, C, n_c, sh.c_key, sh.c_pos, c_slot,
                            sh.c_pre, now);
  }
  if (n_p > 0) {
    commit_sorted<kT, kIpt>(sh, P, n_p, sh.batch.key, sh.p_pos, p_slot,
                            sh.p_pre, now);
  }
}

template <int kT, int kIpt>
int launch_hier(const Table& C, const Table& P, const int32_t* packed,
                int32_t b, float* out, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(HierShared<kT, kIpt>);
  static_assert(kSmem <= 232448, "fits in an SM's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      hier_block_kernel<kT, kIpt>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = drl_batch::launch_blocks(b);
  hier_block_kernel<kT, kIpt><<<grid, kT, kSmem, stream>>>(C, P, packed, b,
                                                          out);
  return (int)cudaGetLastError();
}

// The debit's rule for tally.cuh: base the refilled balance, x the row's
// applied amount negated. Padding rows read nothing and reply 0.
struct DebitPolicy {
  struct Table {
    float* tokens;
    int32_t* last_ts;
    uint8_t* exists;
    int64_t n;
    float cap;
    float rate;
  };
  struct In {
    float tokens, amount, pre;
    int32_t last_ts;
    uint8_t exists;
  };
  struct Row {
    float base, aux, x;
    bool existed;
  };
  static constexpr bool kPadReadsSlot0 = false;
  static constexpr int64_t kSlotBytes = 9;  // its state's bytes

  static __device__ __forceinline__ In load(const Table& t,
                                            const int32_t* packed, int32_t b,
                                            int64_t i, int64_t g,
                                            bool reads) {
    In in{0.0f, 0.0f, 0.0f, 0, 0};
    if (i >= 0) {
      in.amount = __int_as_float(packed[b + i]);
      in.pre = __int_as_float(packed[3 * (int64_t)b + i]);
    }
    if (reads) {  // a missing slot refills to cap: its tokens are not read
      in.exists = t.exists[g];
      if (in.exists) {
        in.tokens = t.tokens[g];
        in.last_ts = t.last_ts[g];
      }
    }
    return in;
  }
  static __device__ __forceinline__ Row advance(const Table& t, const In& in,
                                                int32_t now) {
    return Row{refill_or_init(in.tokens, in.last_ts, in.exists, now, t.cap,
                              t.rate),
               0.0f, 0.0f, in.exists != 0};
  }
  static __device__ __forceinline__ Row decide(const Table& t, const In& in,
                                               int32_t b, int64_t i,
                                               bool valid, int32_t now,
                                               float* out) {
    if (!valid) {
      out[i] = 0.0f;
      out[b + i] = 0.0f;
      return Row{0.0f, 0.0f, 0.0f, false};
    }
    const Row r = advance(t, in, now);
    const float ref = r.base;
    const float avail = fmaxf(__fsub_rn(ref, in.pre), 0.0f);
    const float applied = fminf(in.amount, avail);
    out[i] = __fsub_rn(avail, applied);
    out[b + i] = __fsub_rn(in.amount, applied);
    return Row{ref, 0.0f, -applied, r.existed};
  }
  static __device__ __forceinline__ void commit(const Table& t, int32_t s,
                                                float value, float,
                                                int32_t now, bool existed) {
    t.tokens[s] = value;
    t.last_ts[s] = now;
    if (!existed) t.exists[s] = 1;
  }
};

}  // namespace

// packed i32[4, B], B <= 4096; out f32[2, B].
extern "C" int drl_acquire_hierarchical(
    float* c_tokens, int32_t* c_last_ts, uint8_t* c_exists, int32_t c_n,
    float c_cap, float c_rate, float* p_tokens, int32_t* p_last_ts,
    uint8_t* p_exists, int32_t p_n, float p_cap, float p_rate,
    const int32_t* packed, int32_t b, float* out, cudaStream_t stream) {
  if (b <= 0) return (int)cudaSuccess;
  const Table C{c_tokens, c_last_ts, c_exists, c_n, c_cap, c_rate};
  const Table P{p_tokens, p_last_ts, p_exists, p_n, p_cap, p_rate};
  if (b <= drl_batch::kWarpRows) {
    hier_warp_kernel<<<1, 32, 0, stream>>>(C, P, packed, b, out);
    return (int)cudaGetLastError();
  }
  if (b <= 64) return launch_hier<64, 1>(C, P, packed, b, out, stream);
  if (b <= 256)
    return launch_hier<256, 1>(C, P, packed, b, out, stream);
  if (b <= 1024)
    return launch_hier<1024, 1>(C, P, packed, b, out, stream);
  if (b <= 2048)
    return launch_hier<1024, 2>(C, P, packed, b, out, stream);
  if (b <= 4096)
    return launch_hier<1024, 4>(C, P, packed, b, out, stream);
  return (int)cudaErrorInvalidValue;
}

// packed i32[4, B] (any int32 B); out f32[2, B]. Past 4096 rows: claim and
// scratch as drl_sync_counters takes them.
extern "C" int drl_debit_packed(float* tokens, int32_t* last_ts,
                                uint8_t* exists, int64_t n,
                                const int32_t* packed, int32_t b, float cap,
                                float rate, float* out, void* claim,
                                void* scratch, cudaStream_t stream) {
  const DebitPolicy::Table T{tokens, last_ts, exists, n, cap, rate};
  return drl_tally::launch<DebitPolicy>(
      T, packed, b, out, static_cast<uint32_t*>(claim), scratch,
      stream);
}

extern "C" int64_t drl_tally_scratch_bytes(int64_t n, int32_t b) {
  return drl_tally::scratch_bytes<DebitPolicy>(n, b);
}

extern "C" int64_t drl_tally_claim_words(int64_t n, int32_t b) {
  return drl_tally::claim_words<DebitPolicy>(n, b);
}
